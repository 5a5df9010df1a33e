"""The eager integrator: ray generation, the masked bounce loop and the AA
average (port of ``ttrt.render.integrator``). It is the port's oracle: it
runs in float32 or float64, for the demo ``Scene`` and for a ``MeshScene``,
and traces through ``render.dispatch``.

Reference: project_scene (TerminalRayTracer.c:965-1069). The pixel x
sample grid is one flat ray batch; the per-ray bounce loop is a
whole-batch loop with a per-ray alive mask that ends when every ray has
ended. Shadow traces are full-batch traces inside the lighting.

Parity notes: the AA jitter is the reference's triangle-wave offset
(TerminalRayTracer.c:992-993); the ray direction keeps the reference's
quirk, screen offset in the camera basis minus the camera ORIGIN
(TerminalRayTracer.c:1005); the pixel is the contribution-weighted color
sum over the contribution total, averaged over samples
(TerminalRayTracer.c:1012-1065).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ttrt_torch.config import RenderConfig, constants
from ttrt_torch.render import dispatch
from ttrt_torch.render.lighting import apply_lighting
from ttrt_torch.render.skybox import sample_skybox
from ttrt_torch.scene import HIT_NONE
from ttrt_torch.vec import Vec3, scalar_like, triangle_wave


def generate_rays(scene, cfg: RenderConfig, row_start=0,
                  n_rows: Optional[int] = None) -> Tuple[Vec3, Vec3]:
    """The flat (n_rows*W*spp,) primary ray batch in pixel-major order
    (TerminalRayTracer.c:980-1011): ray index (row*W + col)*N + k."""
    dtype = cfg.dtype
    cam = scene.camera
    device = cam.frame.origin.device
    W, H, N = cfg.width, cfg.height, cfg.rays_per_pixel
    if n_rows is None:
        n_rows = H
    sw = cam.screen_width.to(dtype)
    sh = cam.screen_height.to(dtype)
    w_t, h_t, n_t = (scalar_like(v, sw) for v in (W, H, N))
    pixel_w = sw / w_t
    pixel_h = sh / h_t

    ar = lambda n: torch.arange(n, dtype=dtype, device=device)  # noqa: E731
    col = ar(W)
    row = ar(n_rows) + scalar_like(row_start, sw)
    k = ar(N)
    base_x = (col / w_t) * sw - sw / 2.0
    base_y = -((row / h_t) * sh - sh / 2.0)
    jit_x = triangle_wave(2.0 * constants.PI * k / n_t) / 2.0 * pixel_w
    jit_y = triangle_wave(constants.PI * k / n_t) / 2.0 * pixel_h
    sx = (base_x[None, :, None] + jit_x[None, None, :]).expand(
        n_rows, W, N).reshape(-1)
    sy = (base_y[:, None, None] + jit_y[None, None, :]).expand(
        n_rows, W, N).reshape(-1)
    sz = -cam.screen_distance.to(dtype)

    basis = cam.frame.basis.to(dtype)
    bx, by, bz = basis[0], basis[1], basis[2]
    origin = cam.frame.origin.to(dtype)
    # reference quirk: direction = offset in basis - camera origin
    # (TerminalRayTracer.c:1005), then the guarded normalize
    d = Vec3(*(sx * bx[i] + sy * by[i] + sz * bz[i] - origin[i]
               for i in range(3))).normalize()
    o = Vec3(*(origin[i].expand_as(d.x) for i in range(3)))
    return o, d


def trace_batch(scene, o: Vec3, d: Vec3, cfg: RenderConfig, *,
                count_rays: bool = False) -> Tuple[Vec3, torch.Tensor]:
    """Run the masked bounce loop on a ray batch. Returns the per-ray
    normalized color and the count of traces performed (primary, bounce
    and shadow rays: bounces + hits x n_lights)."""
    n_lights = scene.directional_lights.count + scene.point_lights.count
    zero = torch.zeros_like(o.x)
    pixel = Vec3(zero, zero, zero)
    contribution = torch.ones_like(o.x)
    total = zero
    still_going = torch.ones_like(o.x, dtype=torch.bool)
    sky_dir = d
    sky_weight = zero
    ray_count = torch.zeros((), dtype=torch.int64, device=o.x.device)

    for _ in range(cfg.bounce_limit):
        alive = still_going & (contribution > constants.CONTRIBUTION_EPS)
        if not bool(alive.any()):
            break
        # the sky is sampled once after the loop, at the direction and
        # weight of the ray's miss (it is always the ray's last term)
        hit = dispatch.trace(scene, o, d, sample_sky=False)
        is_hit = hit.kind != HIT_NONE
        miss_now = alive & ~is_hit
        lit = apply_lighting(scene, hit.point, -d, hit.normal,
                             hit.material.color, hit.material.specularity,
                             specular=cfg.specular)
        color = lit.where(is_hit, Vec3(zero, zero, zero))
        sky_weight = torch.where(miss_now, contribution, sky_weight)
        sky_dir = d.where(miss_now, sky_dir)
        total = total + torch.where(alive, contribution, 0.0)
        if cfg.energy_model == "subtract":
            # TerminalRayTracer.c:24-28: local shading weighted by
            # (1 - reflectivity), no normalization
            cw = contribution * (1.0 - hit.material.reflectivity)
        else:
            cw = contribution
        pixel = Vec3(*(p + torch.where(alive, cw * c, 0.0)
                       for p, c in zip(pixel, color)))
        contribution = torch.where(
            alive,
            torch.where(is_hit, contribution * hit.material.reflectivity,
                        0.0),
            contribution)
        still_going = torch.where(alive, is_hit, still_going)
        if count_rays:
            ray_count = ray_count + alive.sum() + (alive & is_hit).sum() \
                * n_lights
        # reflected continuation (TerminalRayTracer.c:1054-1056)
        d = d.reflect(hit.normal).normalize()
        o = hit.point

    sky = sample_skybox(scene.skybox, sky_dir, bilinear=cfg.skybox_bilinear)
    pixel = Vec3(*(p + sky_weight * s for p, s in zip(pixel, sky)))
    if cfg.energy_model == "subtract":
        return pixel, ray_count  # the path weights partition unity
    inv_total = 1.0 / total  # total >= 1: the first bounce always counts
    return pixel * inv_total, ray_count


def _average(color: Vec3, n_rows: int, cfg: RenderConfig) -> Vec3:
    """The (n_rows, W) pixels of a pixel-major ray batch: each pixel's N
    samples summed in order, then scaled by 1/N."""
    W, N = cfg.width, cfg.rays_per_pixel

    def avg(c):
        c = c.reshape(n_rows, W, N)
        acc = c[..., 0]
        for k in range(1, N):
            acc = acc + c[..., k]
        return acc * (1.0 / N)

    return Vec3(avg(color.x), avg(color.y), avg(color.z))


def render_frame(scene, cfg: RenderConfig, *, count_rays: bool = False
                 ) -> Tuple[Vec3, torch.Tensor]:
    """Render one frame: the (H, W) framebuffer as a Vec3 of (H, W)
    channels and the trace count (0 unless ``count_rays``)."""
    o, d = generate_rays(scene, cfg)
    color, ray_count = trace_batch(scene, o, d, cfg, count_rays=count_rays)
    return _average(color, cfg.height, cfg), ray_count


def render_frame_tiled(scene, cfg: RenderConfig, n_bands: int = 8, *,
                       count_rays: bool = False
                       ) -> Tuple[Vec3, torch.Tensor]:
    """The high-res still path: render the frame in ``n_bands`` horizontal
    bands, one after another, so that the live ray state is one band's
    instead of the whole frame's. Returns ``render_frame``'s pair; the
    height must divide by ``n_bands``."""
    H = cfg.height
    if H % n_bands:
        raise ValueError(f"height {H} not divisible by n_bands {n_bands}")
    bh = H // n_bands
    bands, rays = [], []
    for i in range(n_bands):
        o, d = generate_rays(scene, cfg, row_start=i * bh, n_rows=bh)
        color, r = trace_batch(scene, o, d, cfg, count_rays=count_rays)
        bands.append(_average(color, bh, cfg))
        rays.append(r)
    fb = Vec3(*(torch.cat(channel) for channel in zip(*bands)))
    return fb, torch.stack(rays).sum()
