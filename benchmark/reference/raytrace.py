"""The eager integrator (project_scene, TerminalRayTracer.c:965-1069) over
either scene kind: ray generation, the bounce loop with its contribution
weights, the Lambertian lighting with shadow rays, the sky at the miss,
the in-order sample average and the u8 quantization.

Parity notes kept from the source: the AA jitter is its triangle-wave
offset (TerminalRayTracer.c:992-993); the ray direction is the screen
offset in the camera basis minus the camera ORIGIN (c:1005); n.l is
clamped above at 1 but not below (c:911, 945); a point light is lit when
its shadow trace misses or the blocker lies beyond it (c:937-942); the
lit color is clamped to [0, 1] (c:960); the pixel is the weighted color
sum over the contribution total (c:1012-1065); the quantization is C's
(int)(c * 255) (c:1157-1163).

Each bounce traces only the rays still alive and lights only those that
hit: a ray that ends never lives again, and every ray's arithmetic is its
own, so this gives the masked whole-batch loop's values.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from benchmark.reference.camera import Camera, orbit_camera
from benchmark.reference.scene import HIT_NONE
from benchmark.reference.vec import (CONTRIBUTION_EPS, PI, Vec3, scalar_like,
                                     triangle_wave)


def primary_rays(cam: Camera, width: int, height: int, spp: int,
                 rows: Optional[torch.Tensor] = None) -> Tuple[Vec3, Vec3]:
    """The (len(rows) * W * N,) primary rays of the pixel ``rows`` (all by
    default), pixel-major: ray (row * W + col) * N + k."""
    sw, sh = cam.screen_width, cam.screen_height
    dtype, device = sw.dtype, sw.device
    w_t, h_t, n_t = (scalar_like(v, sw) for v in (width, height, spp))
    pixel_w, pixel_h = sw / w_t, sh / h_t
    col = torch.arange(width, dtype=dtype, device=device)
    row = (torch.arange(height, dtype=dtype, device=device) if rows is None
           else rows.to(device=device, dtype=dtype))
    k = torch.arange(spp, dtype=dtype, device=device)
    n_rows = row.shape[0]
    base_x = (col / w_t) * sw - sw / 2.0
    base_y = -((row / h_t) * sh - sh / 2.0)
    jit_x = triangle_wave(2.0 * PI * k / n_t) / 2.0 * pixel_w
    jit_y = triangle_wave(PI * k / n_t) / 2.0 * pixel_h
    sx = (base_x[None, :, None] + jit_x[None, None, :]).expand(
        n_rows, width, spp).reshape(-1)
    sy = (base_y[:, None, None] + jit_y[None, None, :]).expand(
        n_rows, width, spp).reshape(-1)
    sz = -cam.screen_distance
    b, org = cam.basis, cam.origin
    d = Vec3(*(sx * b[0][i] + sy * b[1][i] + sz * b[2][i] - org[i]
               for i in range(3))).normalize()
    return Vec3(*(org[i].expand_as(d.x) for i in range(3))), d


def _clamp(v, lo, hi):
    return torch.minimum(torch.maximum(v, torch.full_like(v, lo)),
                         torch.full_like(v, hi))


def lighting(scene, p: Vec3, n: Vec3, color: Vec3) -> Vec3:
    """The lit color of hit points ``p`` with normals ``n``, clamped to
    [0, 1]."""
    zero = torch.zeros_like(p.x)
    zero3 = Vec3(zero, zero, zero)
    out = zero3
    lt = scene.lights
    for i in range(lt.dl_direction.x.shape[0]):
        ldir = Vec3(-lt.dl_direction.x[i], -lt.dl_direction.y[i],
                    -lt.dl_direction.z[i]).normalize()
        ldir_b = zero3 + ldir
        unblocked = scene.trace(p, ldir_b).kind == HIT_NONE
        ndotl = torch.clamp_max(n.dot(ldir_b), 1.0)
        lc = lt.dl_color.take(i)
        c = Vec3(lc.x * ndotl * color.x, lc.y * ndotl * color.y,
                 lc.z * ndotl * color.z)
        out = out + c.where(unblocked, zero3)
    for i in range(lt.pl_intensity.shape[0]):
        lvec = lt.pl_position.take(i) - p
        d2 = lvec.dot(lvec)
        intensity = _clamp(lt.pl_intensity[i] / d2, 0.0, 1.0)
        ldir = lvec.normalize()
        shadow = scene.trace(p, ldir)
        to_block = shadow.point - p
        lit = (shadow.kind == HIT_NONE) | (d2 < to_block.dot(to_block))
        scale = intensity * torch.clamp_max(n.dot(ldir), 1.0)
        lc = lt.pl_color.take(i)
        c = Vec3(lc.x * scale * color.x, lc.y * scale * color.y,
                 lc.z * scale * color.z)
        out = out + c.where(lit, zero3)
    return Vec3(*(torch.clamp(c, 0.0, 1.0) for c in out))


def trace_rays(scene, sky, o: Vec3, d: Vec3, bounce_limit: int
               ) -> Tuple[Vec3, int]:
    """Each ray's normalized color and the traces made (primary, bounce and
    shadow rays: bounces + hits x lights)."""
    n_lights = (scene.lights.dl_direction.x.shape[0]
                + scene.lights.pl_intensity.shape[0])
    zero = torch.zeros_like(o.x)
    pixel = [zero, zero, zero]
    contribution = torch.ones_like(o.x)
    total = zero
    alive = torch.ones_like(o.x, dtype=torch.bool)
    sky_dir = d
    sky_weight = zero
    traces = 0
    for _ in range(bounce_limit):
        alive = alive & (contribution > CONTRIBUTION_EPS)
        idx = alive.nonzero().squeeze(1)
        if idx.numel() == 0:
            break
        oa, da = o.take(idx), d.take(idx)
        ca = contribution[idx]
        hit = scene.trace(oa, da)
        is_hit = hit.kind != HIT_NONE
        hi = is_hit.nonzero().squeeze(1)
        lit = lighting(scene, hit.point.take(hi), hit.normal.take(hi),
                       hit.color.take(hi))
        za = torch.zeros_like(ca)
        color = [za.index_put((hi,), c) for c in lit]
        miss = ~is_hit
        sky_weight = sky_weight.index_put(
            (idx,), torch.where(miss, ca, sky_weight[idx]))
        sky_dir = Vec3(*(s.index_put((idx,), torch.where(miss, a, s[idx]))
                         for s, a in zip(sky_dir, da)))
        total = total.index_put((idx,), total[idx] + ca)
        pixel = [p.index_put((idx,), p[idx] + ca * c)
                 for p, c in zip(pixel, color)]
        contribution = contribution.index_put(
            (idx,), torch.where(is_hit, ca * hit.reflectivity, 0.0))
        alive = alive.index_put((idx,), is_hit)
        traces += int(idx.numel()) + int(hi.numel()) * n_lights
        d = Vec3(*(s.index_put((idx,), a)
                   for s, a in zip(d, da.reflect(hit.normal).normalize())))
        o = Vec3(*(s.index_put((idx,), a) for s, a in zip(o, hit.point)))
    pixel = [p + sky_weight * s
             for p, s in zip(pixel, sky.gather(sky_dir))]
    inv_total = 1.0 / total
    return Vec3(*(p * inv_total for p in pixel)), traces


def average(color: Vec3, n_rows: int, width: int, spp: int) -> Vec3:
    """Each pixel's N samples summed in order, then scaled by 1/N."""
    def avg(c):
        c = c.reshape(n_rows, width, spp)
        acc = c[..., 0]
        for k in range(1, spp):
            acc = acc + c[..., k]
        return acc * (1.0 / spp)

    return Vec3(avg(color.x), avg(color.y), avg(color.z))


def quantize(fb: Vec3) -> torch.Tensor:
    """(rows, W) channels -> (rows, W, 3) uint8 by (int)(c * 255)."""
    return torch.stack([(c * 255.0).to(torch.int32).to(torch.uint8)
                        for c in fb], dim=-1)


def render_rows(scene, sky, cam: Camera, width: int, height: int,
                spp: int, bounce_limit: int,
                rows: Optional[Sequence[int]] = None
                ) -> Tuple[torch.Tensor, int]:
    """The u8 pixels (len(rows), W, 3) of ``rows`` of the frame (every row
    by default) and the traces they took."""
    device = cam.origin.device
    rows_t = None if rows is None else torch.as_tensor(list(rows),
                                                       device=device)
    n_rows = height if rows_t is None else rows_t.shape[0]
    o, d = primary_rays(cam, width, height, spp, rows_t)
    color, traces = trace_rays(scene, sky, o, d, bounce_limit)
    return quantize(average(color, n_rows, width, spp)), traces


def render(scene, sky, config: dict, t: float, seed: int,
           rows: Optional[Sequence[int]] = None, *, dtype, device):
    """(the u8 pixels of ``rows`` of the frame at scene time ``t``, the
    traces they took); ``seed`` is unused (the integrator draws
    nothing)."""
    cam = orbit_camera(t, config["width"], config["height"], dtype=dtype,
                       device=device)
    return render_rows(scene, sky, cam, config["width"],
                       config["height"], config["spp"], config["bounces"],
                       rows)
