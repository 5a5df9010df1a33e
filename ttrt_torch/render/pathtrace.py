"""The eager Monte-Carlo path tracer (port of ``ttrt.render.pathtrace``):
soft shadows from spherical area lights and cosine-sampled diffuse
interreflection. It is the oracle of the path-tracing kernel
(``kernels/pathtrace.py``) and the route for float64, a ``MeshScene`` and
``--still``.

Estimator (per path), as the JAX package's:

    radiance   += throughput * direct_light(hit)   [next-event estimation]
    throughput *= albedo (diffuse) or 1 (specular)
    direction   ~ cosine hemisphere (diffuse) or mirror (specular),
                  chosen per ray with probability = reflectivity
    Russian roulette on the largest channel from bounce 3
    miss: radiance += throughput * sky, the path ends.

Direct lighting samples one point on each light's surface per bounce and
traces the shadow ray with the scene's own nearest-hit trace
(``render.dispatch``), so a ``MeshScene`` works as the demo scene does.

Randomness comes from an explicit ``torch.Generator`` on the scene's
device, never the global RNG. Its stream differs from ``jax.random``'s, so
parity with the JAX package is statistical.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple

import numpy as np
import torch

from ttrt_torch.config import RenderConfig, constants
from ttrt_torch.render import dispatch
from ttrt_torch.render.integrator import generate_rays
from ttrt_torch.render.skybox import sample_skybox
from ttrt_torch.scene import HIT_NONE
from ttrt_torch.vec import Vec3, scalar_like


class AreaLights(NamedTuple):
    """Spherical emitters, struct of arrays over L lights."""

    position: Vec3  # (L,)
    radius: torch.Tensor  # (L,)
    color: Vec3  # (L,)
    intensity: torch.Tensor  # (L,)

    @property
    def count(self) -> int:
        return self.intensity.shape[-1]

    @staticmethod
    def create(positions, radii, colors, intensities, *, dtype,
               device) -> "AreaLights":
        kw = dict(dtype=dtype, device=device)
        return AreaLights(
            position=Vec3.from_array(torch.as_tensor(positions, **kw)),
            radius=torch.as_tensor(radii, **kw),
            color=Vec3.from_array(torch.as_tensor(colors, **kw)),
            intensity=torch.as_tensor(intensities, **kw),
        )

    @staticmethod
    def from_numpy(arrays: Mapping[str, np.ndarray], *, dtype,
                   device) -> "AreaLights":
        """From numpy leaves keyed by field path (``"position.x"``,
        ``"radius"``, ...), the layout of the JAX package's ``AreaLights``:
        this carries its lights into the port."""

        def t(key):
            return torch.as_tensor(np.array(arrays[key]), dtype=dtype,
                                   device=device)

        def v3(prefix):
            return Vec3(t(prefix + ".x"), t(prefix + ".y"), t(prefix + ".z"))

        return AreaLights(v3("position"), t("radius"), v3("color"),
                          t("intensity"))


def default_area_lights(cfg: RenderConfig, device) -> AreaLights:
    """The demo's point light recast as a spherical emitter for the path
    tracer (ttrt/app.py:42-53): at (0, 3, 0), radius 0.5, white,
    intensity 10."""
    return AreaLights.create(positions=[[0.0, 3.0, 0.0]], radii=[0.5],
                             colors=[[1.0, 1.0, 1.0]], intensities=[10.0],
                             dtype=cfg.dtype, device=device)


def _uniform(gen: torch.Generator, like: torch.Tensor, lo, hi):
    """Uniform draws in [lo, hi) of ``like``'s shape, dtype and device."""
    u = torch.rand(like.shape, generator=gen, dtype=like.dtype,
                   device=like.device)
    return lo + u * (hi - lo)


def _uniform_sphere(gen: torch.Generator, like: torch.Tensor) -> Vec3:
    """Uniform directions on the unit sphere."""
    z = _uniform(gen, like, -1.0, 1.0)
    phi = _uniform(gen, like, 0.0, 2.0 * constants.PI)
    r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    return Vec3(r * torch.cos(phi), r * torch.sin(phi), z)


def _cosine_hemisphere(gen: torch.Generator, normal: Vec3) -> Vec3:
    """Cosine-weighted directions about ``normal`` by the sphere-offset
    trick: normalize(n + uniform_sphere) is cosine-distributed."""
    s = _uniform_sphere(gen, normal.x)
    d = normal + s
    tiny = d.dot(d) < 1e-8  # s == -n: fall back to the normal
    return normal.where(tiny, d).normalize()


def _direct_light(scene, lights: AreaLights, gen: torch.Generator, p: Vec3,
                  n: Vec3, albedo: Vec3) -> Vec3:
    """Next-event estimation against every area light, one surface sample
    each: a blocker counts when it is nearer than the sample (squared
    distances, with a relative margin of 1e-4)."""
    out = [torch.zeros_like(p.x) for _ in range(3)]
    for i in range(lights.count):
        lp = Vec3(*(c[i] for c in lights.position))
        s = _uniform_sphere(gen, p.x)
        to_l = lp + s * lights.radius[i] - p
        d2 = to_l.dot(to_l)
        wi = to_l.normalize()
        ndotl = torch.clamp_min(n.dot(wi), 0.0)

        shadow = dispatch.trace(scene, p, wi, sample_sky=False)
        blk = shadow.point - p
        visible = (shadow.kind == HIT_NONE) | (blk.dot(blk)
                                               >= d2 * (1.0 - 1e-4))
        fall = torch.clamp_max(
            lights.intensity[i] / torch.clamp_min(d2, 1e-8), 1.0)
        w = torch.where(visible, fall * ndotl, 0.0)
        out = [o + w * lc[i] * a
               for o, lc, a in zip(out, lights.color, albedo)]
    return Vec3(*out)


def pathtrace_batch(scene, lights: AreaLights, o: Vec3, d: Vec3,
                    cfg: RenderConfig, gen: torch.Generator) -> Vec3:
    """One stochastic bounce chain for every ray; returns its radiance.
    The loop stops early once every path has ended: an ended path's
    radiance, sky weight and sky direction no longer change."""
    zero = torch.zeros_like(o.x)
    radiance = Vec3(zero, zero, zero)
    throughput = Vec3(*(torch.ones_like(o.x) for _ in range(3)))
    alive = torch.ones_like(o.x, dtype=torch.bool)
    sky_dir = d
    sky_w = Vec3(zero, zero, zero)

    for b in range(cfg.bounce_limit):
        if not bool(alive.any()):
            break
        hit = dispatch.trace(scene, o, d, sample_sky=False)
        is_hit = hit.kind != HIT_NONE
        miss_now = alive & ~is_hit
        # the sky is sampled once after the loop, at the miss direction
        sky_w = throughput.where(miss_now, sky_w)
        sky_dir = d.where(miss_now, sky_dir)

        albedo = hit.material.color
        direct = _direct_light(scene, lights, gen, hit.point, hit.normal,
                               albedo)
        add = alive & is_hit
        radiance = Vec3(*(r + torch.where(add, t * c, 0.0)
                          for r, t, c in zip(radiance, throughput, direct)))

        # specular (probability = reflectivity) or diffuse
        spec = _uniform(gen, o.x, 0.0, 1.0) < hit.material.reflectivity
        d_spec = d.reflect(hit.normal).normalize()
        d_diff = _cosine_hemisphere(gen, hit.normal)
        nd = d_spec.where(spec, d_diff)
        # specular keeps the throughput (the branch probability carries
        # the reflectivity); diffuse multiplies by the albedo
        tp = Vec3(*(torch.where(spec, t, t * a)
                    for t, a in zip(throughput, albedo)))

        # Russian roulette on the largest channel from bounce 3
        survive = is_hit
        if b >= 3:
            p_cont = torch.clamp(
                torch.maximum(tp.x, torch.maximum(tp.y, tp.z)), 0.05, 1.0)
            survive = survive & (_uniform(gen, o.x, 0.0, 1.0) < p_cont)
            tp = tp * (1.0 / p_cont)

        throughput = tp.where(alive, throughput)
        alive = alive & survive
        o = hit.point.where(is_hit, o)
        d = nd.where(is_hit, d)

    sky = sample_skybox(scene.skybox, sky_dir, bilinear=cfg.skybox_bilinear)
    return Vec3(*(r + w * s for r, w, s in zip(radiance, sky_w, sky)))


def pathtrace_frame(scene, lights: AreaLights, cfg: RenderConfig,
                    gen: torch.Generator, *, reduce: str = "mean") -> Vec3:
    """One progressive frame: the (H, W) radiance averaged over
    cfg.rays_per_pixel paths a pixel with random subpixel jitter, clipped
    to [0, 1]. ``reduce='sum'`` returns the unclipped per-pixel sum (the
    sample-sharded combine of the JAX package)."""
    if reduce not in ("mean", "sum"):
        raise ValueError(f"reduce must be 'mean' or 'sum', got {reduce!r}")
    dtype = cfg.dtype
    H, W, N = cfg.height, cfg.width, cfg.rays_per_pixel
    o, _ = generate_rays(scene, cfg)
    # pixel-major rays, (row*W + col)*N + k, re-derived with a random
    # jitter in [0, pixel) in place of the triangle wave
    cam = scene.camera
    sw = cam.screen_width.to(dtype)
    sh = cam.screen_height.to(dtype)
    w_t, h_t = scalar_like(W, sw), scalar_like(H, sw)
    like = o.x
    jx = _uniform(gen, like, 0.0, sw / w_t)
    jy = _uniform(gen, like, 0.0, sh / h_t)
    ar = lambda n: torch.arange(n, dtype=dtype, device=like.device)  # noqa: E731
    col = ar(W).repeat_interleave(N).repeat(H)
    row = ar(H).repeat_interleave(W * N)
    sx = (col / w_t) * sw - sw / 2.0 + jx
    sy = -((row / h_t) * sh - sh / 2.0) + jy
    sz = -cam.screen_distance.to(dtype)
    basis = cam.frame.basis.to(dtype)
    origin = cam.frame.origin.to(dtype)
    # reference quirk: direction = offset in basis - camera origin
    d = Vec3(*(sx * basis[0][i] + sy * basis[1][i] + sz * basis[2][i]
               - origin[i] for i in range(3))).normalize()

    color = pathtrace_batch(scene, lights, o, d, cfg, gen)
    if reduce == "sum":
        return Vec3(*(c.reshape(H, W, N).sum(dim=-1) for c in color))
    return Vec3(*(torch.clamp(c.reshape(H, W, N).mean(dim=-1), 0.0, 1.0)
                  for c in color))
