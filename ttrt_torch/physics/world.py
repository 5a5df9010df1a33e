"""Rigid-body sphere world: GJK contacts and impulse response (port of
``ttrt.physics.world``).

Everything is a fixed-shape whole-batch computation:
  - integration is elementwise over the N bodies;
  - collision detection runs ALL i<j pairs through one batched GJK call
    (a static upper-triangle pair list, no broadphase);
  - each body's contact impulses and corrections are added back in a
    fixed order (``_PairSums``), so simultaneous contacts resolve in one
    pass and a run repeats its bits on the card;
  - the step is pure (state, params, dt) -> state, and the state is the
    checkpoint;
  - on the card, one launch of ``csrc/physics.cu::physics_step_kernel``
    steps the world (``physics_step``); ``physics_step_plain``, the eager
    step, is its plain version.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ttrt_torch.kernels import physics as kphysics
from ttrt_torch.physics.gjk import (gjk_distance, polytope_support,
                                    sphere_support)
from ttrt_torch.utils.profiling import PHYSICS_STEPS
from ttrt_torch.vec import Vec3, scalar_like


class PhysicsParams(NamedTuple):
    """Static world parameters (tensors; shapes fixed a scene)."""

    radius: torch.Tensor  # (N,)
    inv_mass: torch.Tensor  # (N,) 0 = static body
    gravity: torch.Tensor  # (3,)
    restitution: torch.Tensor  # scalar
    ground_y: torch.Tensor  # scalar: the floor plane's height
    bounds: torch.Tensor  # scalar: the |x|, |z| soft walls
    # optional STATIC convex obstacles as vertex hulls (B, V, 3): spheres
    # collide with them through the general GJK query (sphere margin
    # against polytope support)
    obstacles: Optional[torch.Tensor] = None


class PhysicsState(NamedTuple):
    """The dynamic state, and the checkpoint: its leaves in order are
    pos.x, pos.y, pos.z, vel.x, vel.y, vel.z, t (the JAX pytree's)."""

    pos: Vec3  # (N,)
    vel: Vec3  # (N,)
    t: torch.Tensor  # sim time, 0-dim


def default_params(radii, *, dtype: torch.dtype = torch.float32,
                   device="cuda", ground_y=-2.0, restitution=0.85,
                   bounds=6.0, obstacles=None) -> PhysicsParams:
    kw = dict(dtype=dtype, device=device)
    radii = torch.as_tensor(radii, **kw)
    # mass ~ volume; JAX's x ** 3 is x * (x * x), bit for bit x * x * x
    top = radii.max()
    inv_mass = (scalar_like(1.0, radii)
                / ((radii * radii * radii) / (top * top * top)))
    return PhysicsParams(
        radius=radii,
        inv_mass=inv_mass,
        gravity=torch.tensor([0.0, -9.81, 0.0], **kw),
        restitution=torch.tensor(restitution, **kw),
        ground_y=torch.tensor(ground_y, **kw),
        bounds=torch.tensor(bounds, **kw),
        obstacles=(None if obstacles is None
                   else torch.as_tensor(np.asarray(obstacles), **kw)),
    )


def box_obstacle(center, half_extents) -> np.ndarray:
    """(1, 8, 3) float32 vertex hull of an axis-aligned box obstacle."""
    c = np.asarray(center, np.float64)
    h = np.asarray(half_extents, np.float64)
    corners = np.array(
        [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
        np.float64)
    return (c + corners * h)[None].astype(np.float32)


def _pair_indices(n: int) -> Tuple[np.ndarray, np.ndarray]:
    iu = np.triu_indices(n, k=1)
    return iu[0].astype(np.int64), iu[1].astype(np.int64)


class _PairSums:
    """Adds each pair's values to its two bodies in a fixed order: a
    body's contributions as body i of a pair (in pair order), then as
    body j (in pair order), one at a time, the order in which JAX's
    ``base.at[ii].add(a).at[jj].add(b)`` lists its updates. Every body is
    in n - 1 pairs, so the (n, n - 1) table of positions in the
    concatenated [a; b] values has no padding; no atomic add is used, so
    a run gives the same bits every time on the card."""

    def __init__(self, ii: np.ndarray, jj: np.ndarray, n: int, device):
        p = len(ii)
        rows = [[q for q in range(p) if ii[q] == k]
                + [p + q for q in range(p) if jj[q] == k] for k in range(n)]
        self.table = torch.as_tensor(np.asarray(rows, np.int64),
                                     device=device)

    def __call__(self, base: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
        """base (C, n) + the pair values a, b (C, P) of each channel."""
        vals = torch.cat([a, b], dim=1)[:, self.table]  # (C, n, n - 1)
        for k in range(vals.shape[-1]):
            base = base + vals[..., k]
        return base


@functools.lru_cache(maxsize=None)
def _pair_plan(n: int, device: torch.device):
    """The (ii, jj) pair index tensors of ``n`` bodies on ``device`` and
    their ``_PairSums``, or None without pairs; built once a body count
    and device, not every step."""
    ii, jj = _pair_indices(n)
    if ii.size == 0:
        return None
    return (torch.as_tensor(ii, device=device),
            torch.as_tensor(jj, device=device), _PairSums(ii, jj, n, device))


def physics_step(state: PhysicsState, params: PhysicsParams, dt,
                 substeps: int = 1) -> PhysicsState:
    """Advance the world by dt in ``substeps`` equal steps: semi-implicit
    Euler, GJK contacts, impulse response, positional de-penetration,
    ground and soft-wall bounces.

    A world the physics step kernel takes (``kernels/physics.py::takes``:
    float32 on a CUDA device, no obstacles, its bodies and pairs in one
    block) is stepped in one launch of it, with the same bits; any other
    (the CPU, bfloat16 or float64, obstacles) by ``physics_step_plain``.
    ``profiling.PHYSICS_STEPS`` counts the steps of each route."""
    if kphysics.takes(state, params):
        PHYSICS_STEPS.kernel += 1
        return kphysics.physics_step_cuda(state, params, dt, substeps)
    PHYSICS_STEPS.eager += 1
    return physics_step_plain(state, params, dt, substeps)


def physics_step_plain(state: PhysicsState, params: PhysicsParams, dt,
                       substeps: int = 1) -> PhysicsState:
    """``physics_step`` as eager torch ops on the state's device, and the
    plain version of the physics step kernel: every world, obstacles
    included."""
    n = params.radius.shape[0]
    device = params.radius.device
    plan = _pair_plan(n, device)
    dt = torch.as_tensor(dt, dtype=state.pos.x.dtype, device=device)
    h = dt / scalar_like(substeps, dt)
    gx, gy, gz = params.gravity.unbind()
    restitution = params.restitution
    movable_body = params.inv_mass > 0

    def gather(v: Vec3, idx) -> Vec3:
        return Vec3(v.x[idx], v.y[idx], v.z[idx])

    s = state
    for _ in range(substeps):
        vel = Vec3(s.vel.x + gx * h * movable_body,
                   s.vel.y + gy * h * movable_body,
                   s.vel.z + gz * h * movable_body)
        pos = Vec3(s.pos.x + vel.x * h, s.pos.y + vel.y * h,
                   s.pos.z + vel.z * h)

        if plan is not None:
            # --- sphere-sphere contacts through the GENERAL GJK query
            ii, jj, pair_sums = plan
            pa = gather(pos, ii)
            pb = gather(pos, jj)
            dist, normal = gjk_distance(
                sphere_support(pa, params.radius[ii]),
                sphere_support(pb, params.radius[jj]), pa - pb)  # B -> A

            pen = torch.clamp_min(-dist, 0.0)
            touching = dist < 0.0
            vn = (gather(vel, ii) - gather(vel, jj)).dot(normal)
            act = touching & (vn < 0.0)

            ima = params.inv_mass[ii]
            imb = params.inv_mass[jj]
            im_sum = torch.clamp_min(ima + imb, 1e-12)
            jimp = torch.where(act, -(1.0 + restitution) * vn / im_sum, 0.0)
            # positional correction (projection, mass-weighted)
            corr = torch.where(touching, pen / im_sum, 0.0)
            nrm = normal.to_array().T  # (3, P)
            # channels: the velocity impulses, then the corrections
            a = torch.cat([jimp * ima * nrm, corr * ima * nrm])
            b = torch.cat([-jimp * imb * nrm, -corr * imb * nrm])
            out = pair_sums(torch.stack([*vel, *pos]), a, b)
            vel, pos = Vec3(*out[:3]), Vec3(*out[3:])

        if params.obstacles is not None:
            # --- sphere vs static convex obstacles through the GENERAL
            # GJK query (polytope support = argmax-dot over the hull)
            B = params.obstacles.shape[0]

            def rep(c):
                return torch.repeat_interleave(c, B)

            pa = Vec3(rep(pos.x), rep(pos.y), rep(pos.z))  # (n*B,)
            verts = params.obstacles.repeat(n, 1, 1)  # (n*B, V, 3)
            centers = verts.mean(dim=1)
            guess = Vec3(pa.x - centers[:, 0], pa.y - centers[:, 1],
                         pa.z - centers[:, 2])
            dist, normal = gjk_distance(
                sphere_support(pa, rep(params.radius)),
                polytope_support(verts), guess)
            pen = torch.clamp_min(-dist, 0.0)
            touching = dist < 0.0
            vn = Vec3(rep(vel.x), rep(vel.y), rep(vel.z)).dot(normal)
            act = touching & (vn < 0.0)
            movable = rep(params.inv_mass) > 0
            dv = torch.where(act & movable, -(1.0 + restitution) * vn, 0.0)
            corr = torch.where(touching & movable, pen, 0.0)

            def acc(v):  # a sphere's contributions over its B obstacles
                return v.reshape(n, B).sum(dim=1)

            vel = Vec3(*(c + acc(dv * nc) for c, nc in zip(vel, normal)))
            pos = Vec3(*(c + acc(corr * nc) for c, nc in zip(pos, normal)))

        # --- ground plane (y = ground_y): clamp and restitution bounce
        floor = params.ground_y + params.radius
        below = pos.y < floor
        pos = pos._replace(y=torch.where(below, floor, pos.y))
        vel = vel._replace(y=torch.where(below & (vel.y < 0),
                                         -restitution * vel.y, vel.y))

        # --- soft walls at |x|, |z| = bounds keep the demo in frame
        hi = params.bounds - params.radius
        for axis in ("x", "z"):
            p = getattr(pos, axis)
            v = getattr(vel, axis)
            over = p > hi
            under = p < -hi
            p = torch.where(over, hi, torch.where(under, -hi, p))
            v = torch.where(over & (v > 0) | under & (v < 0),
                            -restitution * v, v)
            pos = pos._replace(**{axis: p})
            vel = vel._replace(**{axis: v})

        s = PhysicsState(pos=pos, vel=vel, t=s.t + h)
    return s
