"""Dense blocked nearest-hit tester for the many-object tier (port of
``ttrt.mesh.dense``): every (ray, object) pair is tested, in blocks of rays
x objects so that a full frame against 10k spheres fits in memory.

It is the plain version of the cluster-culled CUDA kernel
(``ttrt_torch.kernels.mesh.cluster_nearest_cuda``), and its narrow tests are
the fused kernel's too; csrc/mesh.cu repeats this arithmetic op for op:

    sphere:   b = 2 (o.d - C.d),  c = o.o - 2 C.o + (|C|^2 - r^2),
              disc = b*b - 4a*c,  hit = disc >= 0 & b < 0 & c > 0,
              t = (-b - sqrt(disc)) * (0.5 / a)
    triangle: Moller-Trumbore with the reference's plane epsilons.

The per-pair terms round as XLA:CPU computes JAX's dense tester, whose
blocked loops it compiles (measured against ``ttrt.mesh.dense`` on this
package's inputs: every lane equal). XLA contracts products into fused
multiply-adds there, and the port writes them out (``_fma``, an fmaf in
the kernel): the 3-term dots C.d and C.o are fma(z, fma(y, x*x')), and so
are the triangle's v and t dots; its det and u dots are fma(z, fma(x,
y*y')); each cross-product term a*b - c*d is fma(a, b, -(c*d)); and
disc = fma(b, b, -(4a*c)). The per-ray terms (a, o.d, o.o) round op by
op, as JAX computes them outside its compiled loops.

Exact float ties go to the lowest object id (spheres before triangles),
whatever order the objects are visited in.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ttrt_torch.config import constants
from ttrt_torch.kernels.render import _dot3, _fma
from ttrt_torch.vec import Vec3, scalar_like, sqrt_rn


def chunks(device: torch.device):
    """(rays, spheres, triangles) of one block of pair tests: large on the
    card, where a block costs a few kernel launches; cache-sized on the
    CPU (1024 x 256 floats, 1 MB), where a 16M-element block would go
    to memory on every op."""
    if device.type == "cpu":
        return 1024, 256, 128
    return 1 << 15, 512, 128


class NearestHit(NamedTuple):
    """Per-ray nearest hit: ``t`` (inf on a miss) and the original object
    id ``obj`` (spheres 0..n-1, then triangles; -1 on a miss)."""

    t: torch.Tensor
    obj: torch.Tensor


def sphere_ccr2(spheres) -> torch.Tensor:
    """|C|^2 - r^2 per sphere, in the cluster pack's op order."""
    c = spheres.center
    r = spheres.radius
    return c.x * c.x + c.y * c.y + c.z * c.z - r * r


def _dot_zyx(ax, ay, az, bx, by, bz):
    """ax*bx + ay*by + az*bz as fma(az, bz, fma(ay, by, ax*bx))."""
    return _fma(az, bz, _fma(ay, by, ax * bx))


def _cross_term(a, b, c, d):
    """a*b - c*d as fma(a, b, -(c*d))."""
    return _fma(a, b, -(c * d))


def _sphere_t(cx, cy, cz, ccr2, ox, oy, oz, dx, dy, dz, od, oo, fa, inv2a):
    """(t, hit) of the expanded quadratic on broadcast (objects, rays)
    blocks."""
    cd = _dot_zyx(cx, cy, cz, dx, dy, dz)
    co = _dot_zyx(cx, cy, cz, ox, oy, oz)
    b = 2.0 * (od - cd)
    c = oo - 2.0 * co + ccr2
    disc = _fma(b, b, -(fa * c))
    hit = (disc >= 0.0) & (b < 0.0) & (c > 0.0)
    t0 = (-b - sqrt_rn(torch.clamp_min(disc, 0.0))) * inv2a
    return t0, hit


def sphere_blocks(cx, cy, cz, ccr2, hx, hy, hz, lx, ly, lz, soo, od, tmax):
    """Shadow any-hit of the expanded quadratic along UNIT directions
    (a == 1) on broadcast (objects, rays) blocks, blockers before ``tmax``
    only when it is not None (t0 < tmax <=> sqrt(disc) > -b - 2 tmax)."""
    co = _dot_zyx(cx, cy, cz, hx, hy, hz)
    cc = soo - 2.0 * co + ccr2
    cd = _dot_zyx(cx, cy, cz, lx, ly, lz)
    b = 2.0 * (od - cd)
    disc = _fma(b, b, -(4.0 * cc))
    hit = (disc >= 0.0) & (b < 0.0) & (cc > 0.0)
    if tmax is not None:
        rhs = -b - 2.0 * tmax
        hit = hit & ((rhs < 0.0) | (disc > rhs * rhs))
    return hit


def _tri_t(v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z, ox, oy, oz, dx, dy,
           dz):
    """(t, hit) of Moller-Trumbore on broadcast (objects, rays) blocks."""
    px = _cross_term(dy, e2z, dz, e2y)
    py = _cross_term(dz, e2x, dx, e2z)
    pz = _cross_term(dx, e2y, dy, e2x)
    det = _dot3(e1x, e1y, e1z, px, py, pz)
    ok = torch.abs(det) > constants.PLANE_DENOM_EPS
    inv = 1.0 / torch.where(ok, det, 1.0)
    sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
    u = _dot3(sx, sy, sz, px, py, pz) * inv
    qx = _cross_term(sy, e1z, sz, e1y)
    qy = _cross_term(sz, e1x, sx, e1z)
    qz = _cross_term(sx, e1y, sy, e1x)
    v = _dot_zyx(dx, dy, dz, qx, qy, qz) * inv
    t = _dot_zyx(e2x, e2y, e2z, qx, qy, qz) * inv
    hit = (ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t > constants.PLANE_T_EPS))
    return t, hit


def _take_min(bt, bo, t, hit, base):
    """Fold one (objects, rays) block into the running (t, id) winner:
    the block's first minimum is its lowest id, and a later block (higher
    ids) replaces the winner only on a strictly smaller t."""
    t = torch.where(hit, t, torch.inf)
    cmin, carg = torch.min(t, dim=0)
    take = cmin < bt
    return (torch.where(take, cmin, bt),
            torch.where(take, carg.to(torch.int32) + base, bo))


def nearest_arrays(sph: Optional[torch.Tensor], tri: Optional[torch.Tensor],
                   n_spheres: int, o: Vec3, d: Vec3) -> NearestHit:
    """Nearest (t, id) over objects given as id-ordered rows: ``sph``
    (n, 4) = cx cy cz ccr2, ``tri`` (m, 9) = v0 e1 e2; triangle ids start
    at ``n_spheres``. Rays are flat (R,) components."""
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
    return NearestHit(out_t, out_o)


def object_rows(spheres, triangles):
    """The id-ordered (n, 4) sphere rows and (m, 9) triangle rows of
    ``nearest_arrays``."""
    sph = tri = None
    if spheres is not None and spheres.count:
        c = spheres.center
        sph = torch.stack([c.x, c.y, c.z, sphere_ccr2(spheres)], dim=-1)
    if triangles is not None and triangles.count:
        tri = torch.stack([*triangles.v0, *triangles.e1, *triangles.e2],
                          dim=-1)
    return sph, tri


def dense_nearest(spheres, triangles, o: Vec3, d: Vec3) -> NearestHit:
    """Nearest (t, object id) over all spheres and triangles by blocked
    exhaustive testing. Directions need not be normalized (the 1/(2a)
    factor is per ray)."""
    sph, tri = object_rows(spheres, triangles)
    n_spheres = spheres.count if spheres is not None else 0
    return nearest_arrays(sph, tri, n_spheres, o, d)
