"""The many-object scene (the source's TODO "hierarchy/acceleration
structures", TerminalRayTracer.c:21-33): n random spheres in a slab above
a 512-triangle checker floor, the demo's lights with the point light at
(0, 4, 0), and its trace by the dense tester, every (ray, object) pair
tested in blocks.

The draw is NumPy's ``default_rng(seed)``: centers uniform in [-15, 15] x
[-1.5, 8] x [-15, 15], radii in [0.05, 0.25], colors in [0.1, 1.0],
reflectivity in [0, 0.9], each rounded to float32.

The pair tests are the expanded quadratic and Moller-Trumbore with the
plane epsilons, their fused multiply-adds written out (``fma``):

    sphere:   b = 2 (o.d - C.d),  c = o.o - 2 C.o + (|C|^2 - r^2),
              disc = fma(b, b, -(4a c)),  hit = disc >= 0 & b < 0 & c > 0,
              t = (-b - sqrt(disc)) * (0.5 / a)

Exact ties go to the lowest object id, spheres before triangles. The hit
record is then the demo trace's (EPSILON back-offset, guarded normalize).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from benchmark.reference.scene import (HIT_NONE, HIT_SPHERE, HIT_TRIANGLE,
                                       Hit, Lights, Spheres, lights)
from benchmark.reference.vec import (EPSILON, PLANE_DENOM_EPS, PLANE_T_EPS,
                                     Vec3, dot3, dot_zyx, fma, scalar_like,
                                     sqrt_rn)

FLOOR_Y, FLOOR_HALF_EXTENT, FLOOR_CELLS = -2.0, 20.0, 16
FLOOR_EVEN, FLOOR_ODD, FLOOR_REFLECTIVITY = (1.0, 1.0, 1.0), \
    (1.0, 0.0, 0.0), 0.2


def draw_spheres(seed: int, n: int) -> dict:
    """The seed's spheres as float32 arrays: center (n, 3), radius,
    color (n, 3), reflectivity."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    centers = np.stack([rng.uniform(-15.0, 15.0, n), rng.uniform(-1.5, 8.0, n),
                        rng.uniform(-15.0, 15.0, n)], axis=-1).astype(f32)
    radius = rng.uniform(0.05, 0.25, n).astype(f32)
    color = rng.uniform(0.1, 1.0, (n, 3)).astype(f32)
    refl = rng.uniform(0.0, 0.9, n).astype(f32)
    return {"center": centers, "radius": radius, "color": color,
            "reflectivity": refl}


def floor_triangles() -> dict:
    """The checker floor, cells x cells quads of two triangles each, wound
    counter-clockwise seen from +y, colored by the floor(x) + floor(z)
    parity at the cell corner: float64 v0, e1, e2, normal (M, 3) and
    color (M, 3)."""
    xs = np.linspace(-FLOOR_HALF_EXTENT, FLOOR_HALF_EXTENT, FLOOR_CELLS + 1)
    tris, cols = [], []
    for i in range(FLOOR_CELLS):
        for j in range(FLOOR_CELLS):
            x0, x1, z0, z1 = xs[i], xs[i + 1], xs[j], xs[j + 1]
            a, b = (x0, FLOOR_Y, z0), (x1, FLOOR_Y, z0)
            c, dd = (x1, FLOOR_Y, z1), (x0, FLOOR_Y, z1)
            tris += [(a, c, b), (a, dd, c)]
            odd = (int(np.floor(x0)) + int(np.floor(z0))) & 1
            cols += [FLOOR_ODD if odd else FLOOR_EVEN] * 2
    v = np.asarray(tris, np.float64)
    e1, e2 = v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]
    n = np.cross(e1, e2)
    norm = np.linalg.norm(n, axis=-1, keepdims=True)
    return {"v0": v[:, 0], "e1": e1, "e2": e2,
            "normal": n / np.where(norm == 0.0, 1.0, norm),
            "color": np.asarray(cols, np.float64)}


class ManyScene(NamedTuple):
    spheres: Spheres
    sph_rows: torch.Tensor  # (n, 4): cx cy cz |C|^2 - r^2
    tri_rows: torch.Tensor  # (m, 9): v0 e1 e2
    tri_normal: Vec3
    tri_color: Vec3
    tri_reflectivity: torch.Tensor
    lights: Lights

    def trace(self, o: Vec3, d: Vec3) -> Hit:
        return trace(self, o, d)


def build(config: dict, *, dtype, device) -> ManyScene:
    """The scene of ``config['n_spheres']`` spheres drawn from
    ``config['seed']``."""
    s = draw_spheres(config["seed"], config["n_spheres"])

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    def v(a):
        return Vec3(*(t(a[:, i]) for i in range(3)))

    spheres = Spheres(v(s["center"]), t(s["radius"]), v(s["color"]),
                      t(s["reflectivity"]))
    c, r = spheres.center, spheres.radius
    ccr2 = c.x * c.x + c.y * c.y + c.z * c.z - r * r
    f = floor_triangles()
    v0, e1, e2 = v(f["v0"]), v(f["e1"]), v(f["e2"])
    return ManyScene(
        spheres, torch.stack([c.x, c.y, c.z, ccr2], dim=-1),
        torch.stack([*v0, *e1, *e2], dim=-1), v(f["normal"]), v(f["color"]),
        torch.full((f["v0"].shape[0],), FLOOR_REFLECTIVITY, dtype=dtype,
                   device=device),
        lights([-1.0, -1.0, -1.0], [0.0, 4.0, 0.0], dtype=dtype,
               device=device))


def chunks(device: torch.device):
    """(rays, spheres, triangles) of one block of pair tests."""
    if device.type == "cpu":
        return 1024, 256, 128
    return 1 << 15, 512, 128


def _sphere_t(cx, cy, cz, ccr2, ox, oy, oz, dx, dy, dz, od, oo, fa, inv2a):
    cd = dot_zyx(cx, cy, cz, dx, dy, dz)
    co = dot_zyx(cx, cy, cz, ox, oy, oz)
    b = 2.0 * (od - cd)
    c = oo - 2.0 * co + ccr2
    disc = fma(b, b, -(fa * c))
    hit = (disc >= 0.0) & (b < 0.0) & (c > 0.0)
    return (-b - sqrt_rn(torch.clamp_min(disc, 0.0))) * inv2a, hit


def _cross(a, b, c, d):
    """a*b - c*d as fma(a, b, -(c*d))."""
    return fma(a, b, -(c * d))


def _tri_t(v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z, ox, oy, oz, dx, dy,
           dz):
    px, py, pz = _cross(dy, e2z, dz, e2y), _cross(dz, e2x, dx, e2z), \
        _cross(dx, e2y, dy, e2x)
    det = dot3(e1x, e1y, e1z, px, py, pz)
    ok = torch.abs(det) > PLANE_DENOM_EPS
    inv = 1.0 / torch.where(ok, det, 1.0)
    sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
    u = dot3(sx, sy, sz, px, py, pz) * inv
    qx, qy, qz = _cross(sy, e1z, sz, e1y), _cross(sz, e1x, sx, e1z), \
        _cross(sx, e1y, sy, e1x)
    v = dot_zyx(dx, dy, dz, qx, qy, qz) * inv
    t = dot_zyx(e2x, e2y, e2z, qx, qy, qz) * inv
    hit = (ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > PLANE_T_EPS))
    return t, hit


def _take_min(bt, bo, t, hit, base):
    t = torch.where(hit, t, torch.inf)
    cmin, carg = torch.min(t, dim=0)
    take = cmin < bt
    return (torch.where(take, cmin, bt),
            torch.where(take, carg.to(torch.int32) + base, bo))


def nearest(sph: Optional[torch.Tensor], tri: Optional[torch.Tensor],
            n_spheres: int, o: Vec3, d: Vec3):
    """Nearest (t, object id) over the id-ordered rows: t inf and id -1 on
    a miss; triangle ids start at ``n_spheres``."""
    R = o.x.shape[0]
    out_t = torch.full((R,), torch.inf, dtype=o.x.dtype, device=o.x.device)
    out_o = torch.full((R,), -1, dtype=torch.int32, device=o.x.device)
    ray_chunk, sphere_chunk, tri_chunk = chunks(o.x.device)
    for r0 in range(0, R, ray_chunk):
        sl = slice(r0, r0 + ray_chunk)
        ox, oy, oz = (c[sl][None, :] for c in o)
        dx, dy, dz = (c[sl][None, :] for c in d)
        bt, bo = out_t[sl], out_o[sl]
        if sph is not None and sph.shape[0]:
            a = dx * dx + dy * dy + dz * dz
            inv2a = scalar_like(0.5, a) / a
            od = ox * dx + oy * dy + oz * dz
            oo = ox * ox + oy * oy + oz * oz
            fa = 4.0 * a
            for s0 in range(0, sph.shape[0], sphere_chunk):
                blk = sph[s0:s0 + sphere_chunk]
                t, hit = _sphere_t(*(blk[:, i, None] for i in range(4)),
                                   ox, oy, oz, dx, dy, dz, od, oo, fa, inv2a)
                bt, bo = _take_min(bt, bo, t, hit, s0)
        if tri is not None and tri.shape[0]:
            for s0 in range(0, tri.shape[0], tri_chunk):
                blk = tri[s0:s0 + tri_chunk]
                t, hit = _tri_t(*(blk[:, i, None] for i in range(9)),
                                ox, oy, oz, dx, dy, dz)
                bt, bo = _take_min(bt, bo, t, hit, n_spheres + s0)
        out_t[sl], out_o[sl] = bt, bo
    return out_t, out_o


def trace(scene: ManyScene, o: Vec3, d: Vec3) -> Hit:
    n_sph = scene.spheres.count
    n_tri = scene.tri_rows.shape[0]
    t, obj = nearest(scene.sph_rows, scene.tri_rows, n_sph, o, d)
    hit_any = obj >= 0
    is_tri = obj >= n_sph
    t = torch.where(hit_any, t, 0.0)
    point = Vec3(o.x + t * d.x, o.y + t * d.y, o.z + t * d.z)
    sidx = torch.clamp(obj, 0, max(n_sph - 1, 0)).long()
    tidx = torch.clamp(obj - n_sph, 0, max(n_tri - 1, 0)).long()
    center = scene.spheres.center.take(sidx)
    normal_raw = scene.tri_normal.take(tidx).where(is_tri, point - center)
    color = scene.tri_color.take(tidx).where(
        is_tri, scene.spheres.color.take(sidx))
    refl = torch.where(is_tri, scene.tri_reflectivity[tidx],
                       scene.spheres.reflectivity[sidx])
    to_origin = (o - point).normalize()
    eps = scalar_like(EPSILON, o.x)
    point_off = Vec3(point.x + to_origin.x * eps, point.y + to_origin.y * eps,
                     point.z + to_origin.z * eps)
    kind = torch.where(hit_any, torch.where(is_tri, HIT_TRIANGLE, HIT_SPHERE),
                       HIT_NONE).to(torch.int32)
    return Hit(kind, point_off.where(hit_any, o),
               normal_raw.where(hit_any, d).normalize(), color,
               torch.where(hit_any, refl, 0.0))
