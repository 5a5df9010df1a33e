"""The physics tier: the demo's six spheres dropped under gravity with
sphere-sphere contacts, stepped a frame at a time, each frame rendered by
``raytrace``'s integrator with the spheres at the state's centres and the
physics camera (the source's roadmap item "GJK collision physics",
TerminalRayTracer README.md:12-21; the settings of the repository's
``run_physics``).

The world, from the configuration's ``physics`` group: the demo's centres
c lifted to (sx c.x, sy c.y + y, sz c.z) and kicked to (k c.z, 0, -k c.x);
inverse masses by volume; gravity, restitution, the ground plane and the
soft walls at |x|, |z| = bounds. A frame advances the world by 1 / fps in
``substeps`` equal steps h; each step, in this order:

- semi-implicit Euler: v += g h (movable bodies), then p += v h;
- every pair i < j (no broadphase) through the batched sphere GJK distance
  (``sphere_gjk``): the signed distance and the unit normal from j to i;
- for a touching pair, the impulse -(1 + e) vn / (im_i + im_j) where it
  approaches (vn < 0), and the de-penetration pen / (im_i + im_j), each
  along the normal, scaled by each body's inverse mass;
- each body's pair terms added to it one at a time in a fixed order
  (``PairSums``): its terms as the first body of a pair, in pair order,
  then as the second;
- the ground: a body below ground_y + r is put on it and its falling
  velocity reflected by e; the walls likewise on x, then z.

The arithmetic is the program's, operation for operation, with the
correctly rounded square root, and no sum depends on a thread's order, so
a float32 run gives the same bits on the CPU as on the card. The world
steps on the CPU (``STEP_DEVICE``): a frame's few hundred tiny operations
take a few ms there and several times that as kernel launches on the
card. A frame renders on the device it is asked for.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from benchmark.reference import demo, raytrace
from benchmark.reference.camera import Camera, orbit_camera
from benchmark.reference.vec import Vec3, scalar_like, sqrt_rn

STEP_DEVICE = torch.device("cpu")
# the distance under which two sphere centres coincide: the normal is then
# the guarded normalize of the centre difference (the program's GJK)
CORE_EPS = 1e-9
CAMERA_TIME_SCALE = 0.3  # the camera orbits at 0.3 x the sim time
CAMERA_PUSH = 3.0  # and its origin is pushed out 3x


class State(NamedTuple):
    pos: Vec3  # (N,) each
    vel: Vec3
    t: torch.Tensor  # the sim time, 0-dim


class World(NamedTuple):
    radius: torch.Tensor  # (N,)
    inv_mass: torch.Tensor  # (N,)
    gravity: torch.Tensor  # (3,)
    restitution: torch.Tensor
    ground_y: torch.Tensor
    bounds: torch.Tensor
    dt: torch.Tensor  # a frame's time, 1 / fps
    substeps: int


class PairSums:
    """Adds each pair's terms to its two bodies one at a time: body k's
    terms as the first body of a pair (in pair order), then as the second
    (in pair order). Every body is in n - 1 pairs, so the (n, n - 1) table
    of positions in the concatenated [first; second] terms is full."""

    def __init__(self, ii: np.ndarray, jj: np.ndarray, n: int):
        p = len(ii)
        rows = [[q for q in range(p) if ii[q] == k]
                + [p + q for q in range(p) if jj[q] == k] for k in range(n)]
        self.table = torch.as_tensor(np.asarray(rows, np.int64))

    def __call__(self, base: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
        """base (C, n) plus the pair terms a, b (C, P) of each channel."""
        vals = torch.cat([a, b], dim=1)[:, self.table]
        for k in range(vals.shape[-1]):
            base = base + vals[..., k]
        return base


def sphere_gjk(pa: Vec3, ra: torch.Tensor, pb: Vec3, rb: torch.Tensor
               ) -> Tuple[torch.Tensor, Vec3]:
    """GJK's signed distance between sphere batches A and B (negative:
    penetrating) and its unit normal from B toward A.

    A sphere is a point core with its radius as a margin, so the Minkowski
    difference of two cores is the one point v = pa - pb whatever the
    search direction: GJK's first support is the closest point, its
    progress test |v|^2 - v.v is exactly 0 in every lane, and the simplex's
    closest-point step never runs. The distance is |v| less the margins;
    the normal v / |v|, or where the cores coincide the guarded normalize
    of the centre difference (the initial direction)."""
    v = pa - pb
    core = sqrt_rn(torch.clamp_min(v.dot(v), 0.0))
    dist = core - (ra + rb)
    safe = torch.clamp_min(core, 1e-12)
    n = Vec3(v.x / safe, v.y / safe, v.z / safe)
    return dist, v.normalize().where(core < CORE_EPS, n)


def world_of(config: dict, *, dtype) -> Tuple[World, State]:
    """The configuration's world and its state at t = 0 on STEP_DEVICE."""
    ph = config["physics"]
    kw = dict(dtype=dtype, device=STEP_DEVICE)
    c = [torch.as_tensor(np.asarray(demo.CENTERS)[:, i], **kw)
         for i in range(3)]
    radius = torch.as_tensor(np.full(len(demo.CENTERS), ph["radius"]), **kw)
    top = radius.max()
    inv_mass = (scalar_like(1.0, radius)
                / ((radius * radius * radius) / (top * top * top)))
    world = World(radius, inv_mass, torch.tensor(ph["gravity"], **kw),
                  torch.tensor(ph["restitution"], **kw),
                  torch.tensor(ph["ground_y"], **kw),
                  torch.tensor(ph["bounds"], **kw),
                  torch.tensor(1.0 / ph["fps"], **kw), ph["substeps"])
    sx, sy, sz = ph["lift"]["scale"]
    k = ph["kick"]
    pos = Vec3(c[0] * sx, c[1] * sy + ph["lift"]["y"], c[2] * sz)
    vel = Vec3(c[2] * k, torch.zeros_like(c[1]), -c[0] * k)
    return world, State(pos, vel, torch.zeros_like(radius[0]))


def step(s: State, w: World, pairs) -> State:
    """One frame: ``w.substeps`` steps of dt / substeps."""
    ii, jj, sums = pairs
    h = w.dt / scalar_like(w.substeps, w.dt)
    gx, gy, gz = w.gravity.unbind()
    e = w.restitution
    movable = w.inv_mass > 0
    for _ in range(w.substeps):
        vel = Vec3(s.vel.x + gx * h * movable, s.vel.y + gy * h * movable,
                   s.vel.z + gz * h * movable)
        pos = Vec3(s.pos.x + vel.x * h, s.pos.y + vel.y * h,
                   s.pos.z + vel.z * h)

        dist, normal = sphere_gjk(pos.take(ii), w.radius[ii], pos.take(jj),
                                  w.radius[jj])
        pen = torch.clamp_min(-dist, 0.0)
        touching = dist < 0.0
        vn = (vel.take(ii) - vel.take(jj)).dot(normal)
        act = touching & (vn < 0.0)
        ima, imb = w.inv_mass[ii], w.inv_mass[jj]
        im_sum = torch.clamp_min(ima + imb, 1e-12)
        jimp = torch.where(act, -(1.0 + e) * vn / im_sum, 0.0)
        corr = torch.where(touching, pen / im_sum, 0.0)
        nrm = torch.stack([normal.x, normal.y, normal.z])  # (3, P)
        a = torch.cat([jimp * ima * nrm, corr * ima * nrm])
        b = torch.cat([-jimp * imb * nrm, -corr * imb * nrm])
        out = sums(torch.stack([*vel, *pos]), a, b)
        vel, pos = Vec3(*out[:3]), Vec3(*out[3:])

        floor = w.ground_y + w.radius
        below = pos.y < floor
        pos = pos._replace(y=torch.where(below, floor, pos.y))
        vel = vel._replace(y=torch.where(below & (vel.y < 0), -e * vel.y,
                                         vel.y))

        hi = w.bounds - w.radius
        for axis in ("x", "z"):
            p, v = getattr(pos, axis), getattr(vel, axis)
            over, under = p > hi, p < -hi
            p = torch.where(over, hi, torch.where(under, -hi, p))
            v = torch.where(over & (v > 0) | under & (v < 0), -e * v, v)
            pos, vel = pos._replace(**{axis: p}), vel._replace(**{axis: v})

        s = State(pos, vel, s.t + h)
    return s


def leaves(s) -> list:
    """A state's seven leaves: pos x, y, z, vel x, y, z, t."""
    return [*s.pos, *s.vel, s.t]


class Drop:
    """The drop, frame by frame: ``at(k)`` is the state after k frames,
    stepped on from the last frame asked for (from t = 0 when k is
    earlier). ``scene`` is the demo scene the frames render, on the
    render device."""

    def __init__(self, config: dict, *, dtype, device):
        self.config = config
        self.scene = demo.build(config, dtype=dtype, device=device)
        self.world, self.start = world_of(config, dtype=dtype)
        ii, jj = (a.astype(np.int64)
                  for a in np.triu_indices(len(demo.CENTERS), k=1))
        ph = config["physics"]
        if ph["broadphase"] or ph["pairs"] != len(ii):
            raise ValueError("the reference steps every pair, with no "
                             "broadphase")
        self.pairs = (torch.as_tensor(ii), torch.as_tensor(jj),
                      PairSums(ii, jj, len(demo.CENTERS)))
        self.k, self.state = 0, self.start

    def frame_of(self, t: float) -> int:
        """The frame whose state a frame at scene time ``t`` shows."""
        return round(t * self.config["physics"]["fps"])

    def at(self, k: int) -> State:
        if k < self.k:
            self.k, self.state = 0, self.start
        while self.k < k:
            self.state = step(self.state, self.world, self.pairs)
            self.k += 1
        return self.state

    def state_gap(self, other) -> Tuple[bool, float]:
        """(bit for bit, the largest |difference|) of another state (any
        object with ``pos``, ``vel`` and ``t``, on any device) against the
        last state asked for."""
        mine = leaves(self.state)
        theirs = [x.detach().to(STEP_DEVICE) for x in leaves(other)]
        same = all(a.dtype == b.dtype and torch.equal(a, b)
                   for a, b in zip(mine, theirs))
        gap = max(float((a.double() - b.double()).abs().max())
                  for a, b in zip(mine, theirs))
        return same, gap


def physics_camera(s: State, config: dict, *, dtype, device) -> Camera:
    """The orbit camera at 0.3 x the sim time, its origin pushed out 3x."""
    t = s.t * scalar_like(CAMERA_TIME_SCALE, s.t)
    cam = orbit_camera(float(t), config["width"], config["height"],
                       dtype=dtype, device=device)
    # plus the arrow keys' offset, zero in a non-interactive run
    origin = (cam.origin * scalar_like(CAMERA_PUSH, cam.origin)
              + torch.zeros(3, dtype=dtype, device=device))
    return cam._replace(origin=origin)


def build(config: dict, *, dtype, device) -> Drop:
    return Drop(config, dtype=dtype, device=device)


def render(drop: Drop, sky, config: dict, t: float, seed: int, rows=None,
           *, dtype, device):
    """(the u8 pixels of ``rows`` of the frame at scene time ``t``: the
    state after ``drop.frame_of(t)`` frames, the traces they took);
    ``seed`` is unused (the world is the configuration's)."""
    s = drop.at(drop.frame_of(t))
    scene = drop.scene
    moved = scene._replace(spheres=scene.spheres._replace(
        center=Vec3(*(c.to(device) for c in s.pos))))
    cam = physics_camera(s, config, dtype=dtype, device=device)
    return raytrace.render_rows(moved, sky, cam, config["width"],
                                config["height"], config["spp"],
                                config["bounces"], rows)
