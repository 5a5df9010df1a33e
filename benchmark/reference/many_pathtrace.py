"""The path tracer on the many-object scene: ``pathtrace``'s estimator and
random stream over ``many``'s scene and dense tester.

The estimator, per path: next-event estimation with one surface sample on
the spherical area light and an any-hit shadow ray cut just short of the
sample (at sqrt(d2) * (1 - 5e-5)), a specular-or-cosine-diffuse
continuation chosen with probability = reflectivity, Russian roulette from
bounce 3, the sky at the exit direction weighted by the throughput at the
miss; the pixel is the in-order sample sum over N clipped to [0, 1]. Every
draw is ``pathtrace``'s hash of (frame seed, ray index, bounce, purpose),
the ray index sample-major in the whole frame (k * W*H + row * W + col),
so rendering a few rows draws what the whole frame would for them.

The trace is ``many.nearest``, every live path against every sphere and
triangle, the lowest id winning an exact tie; a shadow ray is blocked
when any object lies before ``tmax`` along it, by the sqrt-free sphere
test (the direction is a unit vector: t0 < tmax <=> sqrt(disc) > -b -
2 tmax) and Moller-Trumbore at t < tmax. The hit record and every step
of the estimator round as the program's path tracer rounds them, with
the fused multiply-adds written out (``fma``, ``dot3``, ``normalize3``):
a path tracer is chaotic, a ray off by one rounding after a few specular
bounces off the small spheres meets another sphere, so a reference that
rounds otherwise (``many.trace``'s o + t d) parts from the program in
half the pixels of a 10-bounce frame. Each bounce traces only the paths
still alive; a path that ends never lives again, and every path's
arithmetic is its own, so this gives the masked whole-batch loop's
values.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from benchmark.reference import many, pathtrace
from benchmark.reference.camera import orbit_camera
from benchmark.reference.scene import (HIT_NONE, HIT_SPHERE, HIT_TRIANGLE,
                                       Hit)
from benchmark.reference.vec import (EPSILON, Vec3, dot3, dot_zyx, fma,
                                     normalize3, scalar_like, sqrt_rn)

_NEE, _BRANCH, _COSINE, _ROULETTE = 10, 30, 40, 50
_EPS_F32 = float(np.float32(EPSILON))


def build(config: dict, *, dtype, device) -> many.ManyScene:
    """``many``'s scene of ``config['n_spheres']`` spheres drawn from
    ``config['seed']`` over the checker floor."""
    return many.build(config, dtype=dtype, device=device)


def trace(scene: many.ManyScene, o: Vec3, d: Vec3) -> Hit:
    """The nearest hit of each ray (o, d) (``many.nearest``) and its
    record: the point fma(t, d, o) pushed EPSILON back toward the origin
    along the guarded-normalized (o - point), the normalized normal
    (point - center, or the triangle's), the material; on a miss the
    origin, the normalized direction and reflectivity 0."""
    n_sph = scene.spheres.count
    n_tri = scene.tri_rows.shape[0]
    t, obj = many.nearest(scene.sph_rows, scene.tri_rows, n_sph, o, d)
    hit = obj >= 0
    is_tri = obj >= n_sph
    t = torch.where(hit, t, 0.0)
    px, py, pz = fma(t, d.x, o.x), fma(t, d.y, o.y), fma(t, d.z, o.z)
    sidx = torch.clamp(obj, 0, max(n_sph - 1, 0)).long()
    tidx = torch.clamp(obj - n_sph, 0, max(n_tri - 1, 0)).long()
    c = scene.spheres.center.take(sidx)
    tn = scene.tri_normal.take(tidx)
    nx, ny, nz = normalize3(*(torch.where(hit, torch.where(is_tri, m, q - k),
                                          dd)
                              for m, q, k, dd in zip(tn, (px, py, pz), c, d)))
    tox, toy, toz = normalize3(o.x - px, o.y - py, o.z - pz)
    point = Vec3(*(torch.where(hit, fma(to, _EPS_F32, q), oo) for to, q, oo
                   in zip((tox, toy, toz), (px, py, pz), o)))
    color = scene.tri_color.take(tidx).where(
        is_tri, scene.spheres.color.take(sidx))
    refl = torch.where(is_tri, scene.tri_reflectivity[tidx],
                       scene.spheres.reflectivity[sidx])
    kind = torch.where(hit, torch.where(is_tri, HIT_TRIANGLE, HIT_SPHERE),
                       HIT_NONE).to(torch.int32)
    return Hit(kind, point, Vec3(nx, ny, nz), color,
               torch.where(hit, refl, 0.0))


def blocked(scene: many.ManyScene, p: Vec3, d: Vec3,
            tmax: torch.Tensor) -> torch.Tensor:
    """Whether any sphere or triangle meets each ray from p along the UNIT
    direction d at a t in (0, tmax), in blocks: the sqrt-free sphere test
    (t0 < tmax <=> sqrt(disc) > -b - 2 tmax, squared on the positive
    branch) and Moller-Trumbore."""
    R = p.x.shape[0]
    out = torch.zeros(R, dtype=torch.bool, device=p.x.device)
    ray_chunk, sphere_chunk, tri_chunk = many.chunks(p.x.device)
    sph, tri = scene.sph_rows, scene.tri_rows
    for r0 in range(0, R, ray_chunk):
        sl = slice(r0, r0 + ray_chunk)
        hx, hy, hz = (c[sl][None, :] for c in p)
        lx, ly, lz = (c[sl][None, :] for c in d)
        tm = tmax[sl][None, :]
        soo = hx * hx + hy * hy + hz * hz
        od = hx * lx + hy * ly + hz * lz
        hit_any = out[sl]
        for s0 in range(0, sph.shape[0], sphere_chunk):
            cx, cy, cz, ccr2 = (sph[s0:s0 + sphere_chunk, i, None]
                                for i in range(4))
            cc = soo - 2.0 * dot_zyx(cx, cy, cz, hx, hy, hz) + ccr2
            b = 2.0 * (od - dot_zyx(cx, cy, cz, lx, ly, lz))
            disc = fma(b, b, -(4.0 * cc))
            rhs = -b - 2.0 * tm
            hit = ((disc >= 0.0) & (b < 0.0) & (cc > 0.0)
                   & ((rhs < 0.0) | (disc > rhs * rhs)))
            hit_any = hit_any | hit.any(dim=0)
        for s0 in range(0, tri.shape[0], tri_chunk):
            blk = tri[s0:s0 + tri_chunk]
            t, hit = many._tri_t(*(blk[:, i, None] for i in range(9)),
                                 hx, hy, hz, lx, ly, lz)
            hit_any = hit_any | (hit & (t < tm)).any(dim=0)
        out[sl] = hit_any
    return out


def _area_light(config: dict, dtype, device):
    """(position, radius, color, intensity) of the configuration's area
    light, each component a 0-dim tensor."""
    al = config["area_light"]

    def t(v):
        return torch.tensor(float(v), dtype=dtype, device=device)

    return (Vec3(*map(t, al["position"])), t(al["radius"]),
            Vec3(*map(t, al["color"])), t(al["intensity"]))


def render(scene: many.ManyScene, sky, config: dict, t: float, seed: int,
           rows: Optional[Sequence[int]] = None, *, dtype, device):
    """(the u8 pixels (len(rows), W, 3) of ``rows`` of the path-traced
    frame at scene time ``t`` of the user seed ``seed``, every row by
    default; its work: nearest-hit traces, hits, unblocked shadow rays).
    The sky is ``sky.by_face`` (``sky_<name>.py``)."""
    W, H = config["width"], config["height"]
    N, bounce_limit = config["spp"], config["bounces"]
    cam = orbit_camera(t, W, H, dtype=dtype, device=device)
    fseed = pathtrace.frame_seed(seed, t) & pathtrace.MASK32
    lp, lr, lc, lint = _area_light(config, dtype, device)
    rows = list(range(H)) if rows is None else list(rows)
    i64 = dict(dtype=torch.int64, device=device)
    pix = (torch.as_tensor(rows, **i64)[:, None] * W
           + torch.arange(W, **i64)).reshape(-1)
    idx = (torch.arange(N, **i64)[:, None] * (W * H) + pix).reshape(-1)

    # the primary rays: the jittered pixel in the camera basis, minus the
    # camera origin (the source's quirk)
    col = (idx % W).to(dtype)
    row = ((idx % (W * H)) // W).to(dtype)
    (bx0, bx1, bx2), (by0, by1, by2), (bz0, bz1, bz2) = cam.basis
    cox, coy, coz = cam.origin
    szc, sw, sh = -cam.screen_distance, cam.screen_width, cam.screen_height
    w_t, h_t = scalar_like(W, sw), scalar_like(H, sw)
    jit_x = pathtrace._rand(idx, fseed, pathtrace._JITTER_BOUNCE,
                            pathtrace._JITTER, dtype) * (sw / w_t)
    jit_y = pathtrace._rand(idx, fseed, pathtrace._JITTER_BOUNCE,
                            pathtrace._JITTER + 1, dtype) * (sh / h_t)
    sxv = (col / w_t) * sw - sw / 2.0 + jit_x
    syv = -((row / h_t) * sh - sh / 2.0) + jit_y
    d = Vec3(*normalize3(sxv * bx0 + syv * by0 + szc * bz0 - cox,
                         sxv * bx1 + syv * by1 + szc * bz1 - coy,
                         sxv * bx2 + syv * by2 + szc * bz2 - coz))
    o = Vec3(*(c.expand_as(d.x).clone() for c in (cox, coy, coz)))

    zero = torch.zeros_like(d.x)
    rad = [zero, zero, zero]
    tp = [torch.ones_like(d.x)] * 3
    sky_w = [zero, zero, zero]
    alive = torch.ones_like(d.x, dtype=torch.bool)
    nearest = hits = unblocked = 0
    for b in range(bounce_limit):
        live = alive.nonzero().squeeze(1)
        if live.numel() == 0:
            break
        hit = trace(scene, o.take(live), d.take(live))
        is_hit = hit.kind != HIT_NONE
        nearest += int(live.numel())
        hits += int(is_hit.sum())
        miss = live[~is_hit]
        sky_w = [s.index_put((miss,), t_[miss]) for s, t_ in zip(sky_w, tp)]

        hi = live[is_hit]
        ih = idx[hi]
        p, n = hit.point.take(is_hit), hit.normal.take(is_hit)
        c = hit.color.take(is_hit)
        refl = hit.reflectivity[is_hit]
        dh = d.take(hi)
        tph = [t_[hi] for t_ in tp]

        # next-event estimation: one surface sample on the area light
        sx, sy, sz = pathtrace._uniform_sphere(ih, fseed, b, _NEE, dtype)
        tlx, tly, tlz = (fma(lr, s, q) - pc for s, q, pc in
                         zip((sx, sy, sz), lp, p))
        d2 = dot3(tlx, tly, tlz, tlx, tly, tlz)
        wi = Vec3(*normalize3(tlx, tly, tlz))
        ndotl = torch.clamp_min(dot3(*n, *wi), 0.0)
        tmax = sqrt_rn(d2) * (1.0 - 5e-5)
        shadowed = blocked(scene, p, wi, tmax)
        unblocked += int((~shadowed).sum())
        fall = torch.clamp_max(lint / torch.clamp_min(d2, 1e-8), 1.0)
        w = torch.where(shadowed, 0.0, fall * ndotl)
        rad = [r.index_put((hi,), fma(t_ * w * lcc, cc, r[hi]))
               for r, t_, lcc, cc in zip(rad, tph, lc, c)]

        # specular (probability = reflectivity) or cosine-diffuse
        spec = pathtrace._rand(ih, fseed, b, _BRANCH, dtype) < refl
        dn = 2.0 * dot3(*dh, *n)
        spx, spy, spz = normalize3(fma(-dn, n.x, dh.x), fma(-dn, n.y, dh.y),
                                   fma(-dn, n.z, dh.z))
        usx, usy, usz = pathtrace._uniform_sphere(ih, fseed, b, _COSINE,
                                                  dtype)
        cdx, cdy, cdz = n.x + usx, n.y + usy, n.z + usz
        tiny = dot3(cdx, cdy, cdz, cdx, cdy, cdz) < 1e-8
        cdx, cdy, cdz = normalize3(torch.where(tiny, n.x, cdx),
                                   torch.where(tiny, n.y, cdy),
                                   torch.where(tiny, n.z, cdz))
        ntp = [torch.where(spec, t_, t_ * cc) for t_, cc in zip(tph, c)]
        survive = torch.ones_like(spec)
        if b >= 3:
            maxc = torch.maximum(ntp[0], torch.maximum(ntp[1], ntp[2]))
            p_cont = torch.clamp(maxc, 0.05, 1.0)
            survive = pathtrace._rand(ih, fseed, b, _ROULETTE,
                                      dtype) < p_cont
            inv_p = 1.0 / p_cont
            ntp = [t_ * inv_p for t_ in ntp]
        tp = [t_.index_put((hi,), v) for t_, v in zip(tp, ntp)]
        o = Vec3(*(oc.index_put((hi,), pc) for oc, pc in zip(o, p)))
        d = Vec3(*(dc.index_put((hi,), torch.where(spec, s, cd))
                   for dc, s, cd in zip(d, (spx, spy, spz),
                                        (cdx, cdy, cdz))))
        alive = torch.zeros_like(alive).index_put((hi,), survive)

    sky_rgb = sky.by_face(*d)
    out = []
    for s, k, r in zip(sky_w, sky_rgb, rad):
        v = fma(s, k, r).reshape(N, len(rows), W)
        acc = v[0]
        for j in range(1, N):
            acc = acc + v[j]
        v = torch.clamp(acc / scalar_like(N, acc), 0.0, 1.0)
        out.append((v * 255.0).to(torch.int32).to(torch.uint8))
    return torch.stack(out, dim=-1), (nearest, hits, unblocked)
