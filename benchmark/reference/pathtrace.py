"""The Monte-Carlo path tracer's plain version on the demo scene: next-event
estimation with one surface sample on the spherical area light and an
any-hit shadow ray cut just short of it, a specular-or-cosine-diffuse
continuation chosen with probability = reflectivity, Russian roulette
from bounce 3, the sky at the exit direction weighted by the throughput
at the miss, the pixel the in-order sample sum over N clipped to [0, 1].

Every random number is a pure hash of (frame seed, ray index, bounce,
purpose), the ray index sample-major (k * W*H + pixel):

    u = u01(mix32(idx ^ mix32(seed + (bounce*64 + purpose) * 0x9E3779B9)))

and a frame's seed is mix32(seed * 0x9E3779B9) XOR the scene time in
milliseconds (float32, truncated). The hash runs in int64 masked to 32
bits. The trace is the restructured nearest-hit scan (the sphere test
disc >= 0 & b < 0 & c > 0, the compare on t, ties to the first object)
with its fused multiply-adds written out (``fma``, ``dot3``).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import demo
from benchmark.reference.camera import Camera, orbit_camera
from benchmark.reference.vec import (EPSILON, PI, PLANE_DENOM_EPS,
                                     PLANE_T_EPS, dot3, fma, normalize3,
                                     scalar_like, sqrt_rn)

MASK32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9
_JITTER, _NEE, _BRANCH, _COSINE, _ROULETTE = 0, 10, 30, 40, 50
_JITTER_BOUNCE = 63
# the area light: the demo's point light recast at (0, 3, 0), radius 0.5,
# white, intensity 10
AREA_LIGHT = (0.0, 3.0, 0.0, 0.5, 1.0, 1.0, 1.0, 10.0)
_EPS_F32 = float(np.float32(EPSILON))


def _mul32(x, c: int):
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & MASK32


def mix32(x):
    """murmur3's fmix32 on 32-bit values in int64 (or a Python int)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def frame_seed(seed: int, t: float) -> int:
    tq = int(np.float32(t) * np.float32(1000.0)) & MASK32
    fseed = mix32(((seed & MASK32) * GOLDEN) & MASK32) ^ tq
    return fseed - (1 << 32) if fseed >= 1 << 31 else fseed


def _rand(idx, seed: int, bounce: int, purpose: int, dtype):
    sc = ((bounce * 64 + purpose) * GOLDEN) & MASK32
    h = mix32(idx ^ mix32((seed + sc) & MASK32))
    return (h >> 8).to(dtype) * (1.0 / 16777216.0)


def _uniform_sphere(idx, seed, bounce, purpose, dtype):
    z = _rand(idx, seed, bounce, purpose, dtype) * 2.0 - 1.0
    phi = _rand(idx, seed, bounce, purpose + 1, dtype) * (2.0 * PI)
    r = sqrt_rn(torch.clamp_min(fma(-z, z, 1.0), 0.0))
    return r * torch.cos(phi), r * torch.sin(phi), z


def _scene_rows(dtype, device):
    """The demo's spheres (cx cy cz r cr cg cb refl) and plane (point,
    normal, even color and reflectivity, odd color and reflectivity) as
    0-dim tensors."""
    t = lambda v: torch.tensor(v, dtype=dtype, device=device)  # noqa: E731
    sph = [tuple(t(v) for v in (*c, demo.RADIUS, *col, r))
           for c, col, r in zip(demo.CENTERS, demo.COLORS, demo.REFLECTIVITY)]
    r = demo.GROUND_REFLECTIVITY
    plane = tuple(t(v) for v in (0.0, demo.GROUND_Y, 0.0, 0.0, 1.0, 0.0,
                                 *demo.EVEN_COLOR, r, *demo.ODD_COLOR, r))
    return sph, plane


def _trace(ox, oy, oz, dx, dy, dz, sph, plane):
    a = dot3(dx, dy, dz, dx, dy, dz)
    inv2a = scalar_like(0.5, a) / a
    best_t = torch.full_like(dx, torch.finfo(dx.dtype).max)
    zero = torch.zeros_like(dx)
    bcx = bcy = bcz = bcr = bcg = bcb = brefl = zero
    hit_sphere = torch.zeros_like(dx, dtype=torch.bool)
    for (cx, cy, cz, r, scr, scg, scb, srefl) in sph:
        ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
        b = 2.0 * dot3(ocx, ocy, ocz, dx, dy, dz)
        c = fma(-r, r, dot3(ocx, ocy, ocz, ocx, ocy, ocz))
        disc = fma(b, b, -(4.0 * a * c))
        hit = (disc >= 0.0) & (b < 0.0) & (c > 0.0)
        t0 = (-b - sqrt_rn(torch.clamp_min(disc, 0.0))) * inv2a
        take = hit & (t0 < best_t)
        best_t = torch.where(take, t0, best_t)
        hit_sphere = hit_sphere | take
        bcx, bcy, bcz = (torch.where(take, v, w) for v, w in
                         ((cx, bcx), (cy, bcy), (cz, bcz)))
        bcr, bcg, bcb = (torch.where(take, v, w) for v, w in
                         ((scr, bcr), (scg, bcg), (scb, bcb)))
        brefl = torch.where(take, srefl, brefl)

    (ppx, ppy, ppz, pnx, pny, pnz, ecr, ecg, ecb, erefl, ocr, ocg, ocb,
     orefl) = plane
    denom = dot3(dx, dy, dz, pnx, pny, pnz)
    safe = torch.where(denom == 0.0, 1.0, denom)
    tp = dot3(ppx - ox, ppy - oy, ppz - oz, pnx, pny, pnz) / safe
    phit = (torch.abs(denom) > PLANE_DENOM_EPS) & (tp > PLANE_T_EPS)
    take_p = phit & (tp < best_t)
    best_t = torch.where(take_p, tp, best_t)
    hit_any = hit_sphere | take_p
    t = torch.where(hit_any, best_t, 0.0)
    px, py, pz = fma(t, dx, ox), fma(t, dy, oy), fma(t, dz, oz)
    odd = ((torch.floor(px) + torch.floor(pz)).to(torch.int32) & 1) == 1
    cr = torch.where(take_p, torch.where(odd, ocr, ecr), bcr)
    cg = torch.where(take_p, torch.where(odd, ocg, ecg), bcg)
    cb = torch.where(take_p, torch.where(odd, ocb, ecb), bcb)
    refl = torch.where(take_p, torch.where(odd, orefl, erefl), brefl)
    nxr = torch.where(take_p, pnx, px - bcx)
    nyr = torch.where(take_p, pny, py - bcy)
    nzr = torch.where(take_p, pnz, pz - bcz)
    tox, toy, toz = normalize3(ox - px, oy - py, oz - pz)
    px = torch.where(hit_any, fma(tox, _EPS_F32, px), ox)
    py = torch.where(hit_any, fma(toy, _EPS_F32, py), oy)
    pz = torch.where(hit_any, fma(toz, _EPS_F32, pz), oz)
    nx, ny, nz = normalize3(torch.where(hit_any, nxr, dx),
                            torch.where(hit_any, nyr, dy),
                            torch.where(hit_any, nzr, dz))
    return (hit_any, px, py, pz, nx, ny, nz, cr, cg, cb,
            torch.where(hit_any, refl, 0.0))


def _shadow_any_hit(px, py, pz, ldx, ldy, ldz, tmax, oc_terms, plane):
    blocked = torch.zeros_like(px, dtype=torch.bool)
    for (ocx, ocy, ocz, c) in oc_terms:
        b = 2.0 * dot3(ocx, ocy, ocz, ldx, ldy, ldz)
        disc = fma(b, b, -(4.0 * c))
        hit = (disc >= 0.0) & (b < 0.0) & (c > 0.0)
        rhs = -b - 2.0 * tmax
        blocked = blocked | (hit & ((rhs < 0.0) | (disc > rhs * rhs)))
    ppx, ppy, ppz, pnx, pny, pnz = plane[:6]
    denom = dot3(ldx, ldy, ldz, pnx, pny, pnz)
    safe = torch.where(denom == 0.0, 1.0, denom)
    tp = dot3(ppx - px, ppy - py, ppz - pz, pnx, pny, pnz) / safe
    phit = ((torch.abs(denom) > PLANE_DENOM_EPS) & (tp > PLANE_T_EPS)
            & (tp < tmax))
    return blocked | phit


def render_frame(cam: Camera, width: int, height: int, spp: int,
                 bounce_limit: int, seed: int, sky_by_face):
    """(the (H, W, 3) u8 frame, its work: nearest-hit traces, hits,
    unblocked NEE shadow rays) of frame seed ``seed``, in ``cam``'s
    dtype, under the sky ``sky_by_face(dx, dy, dz)``."""
    W, H, N = width, height, spp
    dtype, device = cam.origin.dtype, cam.origin.device
    seed &= MASK32
    sph, plane = _scene_rows(dtype, device)
    lpx, lpy, lpz, lr, lcr, lcg, lcb, lint = (
        torch.tensor(v, dtype=dtype, device=device) for v in AREA_LIGHT)
    n_pixels = W * H
    idx = torch.arange(n_pixels * N, device=device, dtype=torch.int64)
    pix = idx % n_pixels
    col = (pix % W).to(dtype)
    row = (pix // W).to(dtype) + torch.zeros((), dtype=dtype, device=device)
    (bx0, bx1, bx2), (by0, by1, by2), (bz0, bz1, bz2) = cam.basis
    cox, coy, coz = cam.origin
    szc, sw, sh = -cam.screen_distance, cam.screen_width, cam.screen_height
    w_t, h_t = scalar_like(W, sw), scalar_like(H, sw)
    jit_x = _rand(idx, seed, _JITTER_BOUNCE, _JITTER, dtype) * (sw / w_t)
    jit_y = _rand(idx, seed, _JITTER_BOUNCE, _JITTER + 1, dtype) * (sh / h_t)
    sxv = (col / w_t) * sw - sw / 2.0 + jit_x
    syv = -((row / h_t) * sh - sh / 2.0) + jit_y
    dx, dy, dz = normalize3(sxv * bx0 + syv * by0 + szc * bz0 - cox,
                            sxv * bx1 + syv * by1 + szc * bz1 - coy,
                            sxv * bx2 + syv * by2 + szc * bz2 - coz)
    ox, oy, oz = (c.expand_as(dx) for c in (cox, coy, coz))

    zero = torch.zeros_like(dx)
    rad = [zero, zero, zero]
    tp = [torch.ones_like(dx)] * 3
    sky_w = [zero, zero, zero]
    alive = torch.ones_like(dx, dtype=torch.bool)
    nearest = hits = unblocked = 0
    for b in range(bounce_limit):
        (is_hit, px, py, pz, nx, ny, nz, cr, cg, cb,
         refl) = _trace(ox, oy, oz, dx, dy, dz, sph, plane)
        miss_now = alive & ~is_hit
        add = alive & is_hit
        nearest += int(alive.sum())
        hits += int(add.sum())
        sky_w = [torch.where(miss_now, t, s) for t, s in zip(tp, sky_w)]

        oc = []
        for (cx, cy, cz, r, *_m) in sph:
            ocx, ocy, ocz = px - cx, py - cy, pz - cz
            oc.append((ocx, ocy, ocz,
                       fma(-r, r, dot3(ocx, ocy, ocz, ocx, ocy, ocz))))
        sx, sy, sz = _uniform_sphere(idx, seed, b, _NEE, dtype)
        tlx = fma(lr, sx, lpx) - px
        tly = fma(lr, sy, lpy) - py
        tlz = fma(lr, sz, lpz) - pz
        d2 = dot3(tlx, tly, tlz, tlx, tly, tlz)
        wix, wiy, wiz = normalize3(tlx, tly, tlz)
        ndotl = torch.clamp_min(dot3(nx, ny, nz, wix, wiy, wiz), 0.0)
        tmax = sqrt_rn(d2) * (1.0 - 5e-5)
        blocked = _shadow_any_hit(px, py, pz, wix, wiy, wiz, tmax, oc, plane)
        fall = torch.clamp_max(lint / torch.clamp_min(d2, 1e-8), 1.0)
        w = torch.where(blocked, 0.0, fall * ndotl)
        aw = torch.where(add, w, 0.0)
        unblocked += int((add & ~blocked).sum())
        rad = [fma(t * aw * lc, c, r) for t, lc, c, r in
               zip(tp, (lcr, lcg, lcb), (cr, cg, cb), rad)]

        spec = _rand(idx, seed, b, _BRANCH, dtype) < refl
        dn = 2.0 * dot3(dx, dy, dz, nx, ny, nz)
        spx, spy, spz = normalize3(fma(-dn, nx, dx), fma(-dn, ny, dy),
                                   fma(-dn, nz, dz))
        usx, usy, usz = _uniform_sphere(idx, seed, b, _COSINE, dtype)
        cdx, cdy, cdz = nx + usx, ny + usy, nz + usz
        tiny = dot3(cdx, cdy, cdz, cdx, cdy, cdz) < 1e-8
        cdx, cdy, cdz = normalize3(torch.where(tiny, nx, cdx),
                                   torch.where(tiny, ny, cdy),
                                   torch.where(tiny, nz, cdz))
        ntp = [torch.where(spec, t, t * c) for t, c in zip(tp, (cr, cg, cb))]
        survive = True
        if b >= 3:
            maxc = torch.maximum(ntp[0], torch.maximum(ntp[1], ntp[2]))
            p_cont = torch.clamp(maxc, 0.05, 1.0)
            survive = _rand(idx, seed, b, _ROULETTE, dtype) < p_cont
            inv_p = 1.0 / p_cont
            ntp = [t * inv_p for t in ntp]
        tp = [torch.where(add, n, t) for n, t in zip(ntp, tp)]
        ox, oy, oz = (torch.where(add, p, o) for p, o in
                      ((px, ox), (py, oy), (pz, oz)))
        dx = torch.where(add, torch.where(spec, spx, cdx), dx)
        dy = torch.where(add, torch.where(spec, spy, cdy), dy)
        dz = torch.where(add, torch.where(spec, spz, cdz), dz)
        alive = add & survive

    sky = sky_by_face(dx, dy, dz)
    out = []
    for s, k, r in zip(sky_w, sky, rad):
        c = fma(s, k, r).reshape(N, H, W)
        acc = c[0]
        for j in range(1, N):
            acc = acc + c[j]
        c = torch.clamp(acc / scalar_like(N, acc), 0.0, 1.0)
        out.append((c * 255.0).to(torch.int32).to(torch.uint8))
    return torch.stack(out, dim=-1), (nearest, hits, unblocked)


def render(scene, sky, config: dict, t: float, seed: int,
           rows=None, *, dtype, device):
    """(the u8 pixels of ``rows`` of the path-traced frame at scene time
    ``t`` of the user seed ``seed``, its work). The scene is the demo's;
    the sky is ``sky.by_face`` (``sky_<name>.py``)."""
    if config["kind"] != "demo":
        raise ValueError("the path tracer's reference is the demo scene")
    cam = orbit_camera(t, config["width"], config["height"], dtype=dtype,
                       device=device)
    u8, work = render_frame(cam, config["width"], config["height"],
                            config["spp"], config["bounces"],
                            frame_seed(seed, t), sky.by_face)
    return (u8 if rows is None else u8[list(rows)]), work
