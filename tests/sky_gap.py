"""Measure how JAX's jitted sky rounds against its eager oracle, and the
port's image-sky and pixel-rate plain versions against JAX's kernels in
interpret mode, on the CPU.

Run from the repository root:  python tests/sky_gap.py

Prints:

- unpack: of the 256 byte values, how many ``x / float32(255)`` under
  ``jax.jit`` differ from the eager (true) division of
  ``ttrt.render.skybox._unpack``;
- lerp: of random (c00, c01, wu) the share where the jitted
  ``c00 * (1 - wu) + c01 * wu`` equals ``fma(c00, 1 - wu, c01 * wu)``, and
  the share where it differs from the eager lerp; fold: the same for
  ``pr + w * sk`` against ``fma(w, sk, pr)``;
- textured / acc: the demo plain version under the 64-texel starfield
  against JAX's textured ``_render_kernel`` (nearest, bilinear), and the
  pixel-rate plain version against ``_render_kernel_acc``: the pixels
  that differ, max |d|, the 99th percentile, the u8 flips, both trace
  counts; and JAX's acc frame against its own ``render_frame_pallas``;
- the knife share (K1 | K2) of each frame of the image-sky golden.
"""

import os
import sys

_TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_TESTS, os.path.dirname(_TESTS)]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from make_torch_golden import jax_scene, scene_leaves  # noqa: E402
from ttrt.assets import make_colors_skybox, make_starfield_skybox  # noqa: E402
from ttrt.config import RenderConfig as JaxRenderConfig  # noqa: E402
from ttrt.kernels import render_pallas  # noqa: E402
from ttrt.render.skybox import _unpack  # noqa: E402

from ttrt_torch.config import RenderConfig  # noqa: E402
from ttrt_torch.kernels import render  # noqa: E402
from ttrt_torch.scene import scene_from_numpy  # noqa: E402


def _fma32(a, b, c):
    """fmaf in float64 (exact product), rounded once to float32 (but on
    exact ties)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def rounding() -> None:
    texels = jnp.arange(256, dtype=jnp.uint32)
    eager = np.asarray(_unpack(texels, jnp.float32).z)
    jitted = np.asarray(jax.jit(lambda t: _unpack(t, jnp.float32).z)(texels))
    print(f"unpack: {int((eager != jitted).sum())} of 256 byte values differ "
          "between jit and eager")
    rng = np.random.default_rng(0)
    n = 200_000
    c00, c01, wu = (rng.uniform(0, 1, n).astype(np.float32) for _ in range(3))
    lerp = jax.jit(lambda a, b, w: a * (1.0 - w) + b * w)
    got = np.asarray(lerp(c00, c01, wu))
    eager = c00 * (np.float32(1) - wu) + c01 * wu
    fused = _fma32(c00, np.float32(1) - wu, c01 * wu)
    print(f"lerp: jit equals fma(c00, 1-wu, c01*wu) on "
          f"{(got == fused).mean():.4%}, differs from eager on "
          f"{(got != eager).mean():.4%} of {n}")
    pr, w, sk = (rng.uniform(0, 1, n).astype(np.float32) for _ in range(3))
    got = np.asarray(jax.jit(lambda p, a, s: p + a * s)(pr, w, sk))
    print(f"fold: jit equals fma(w, sk, pr) on "
          f"{(got == _fma32(w, sk, pr)).mean():.4%}, differs from eager on "
          f"{(got != pr + w * sk).mean():.4%} of {n}")


def _stats(name, ref, out, rays_ref, rays) -> None:
    ref = np.asarray(ref, np.float64)
    out = np.asarray(out, np.float64)
    d = np.abs(ref - out)
    flips = chip_smoke.quantize_u8(ref) != chip_smoke.quantize_u8(out)
    print(f"{name}: {int((d > 0).any(axis=-1).sum())} of "
          f"{d.shape[0] * d.shape[1]} pixels differ, max |d| {d.max():.3g}, "
          f"99th percentile {np.percentile(d, 99):.3g}, u8 flips "
          f"{int(flips.any(axis=-1).sum())}, traces {int(rays_ref)} (JAX) "
          f"{int(rays)} (port)")


def kernels() -> None:
    w, h, spp, bounces = 16, 8, 2, 3
    for procedural, t in ((None, 1.3), ("colors", 0.7)):
        sky = make_starfield_skybox if procedural is None else \
            make_colors_skybox
        js = jax_scene(t, w, h, sky, 64 if procedural is None else 16,
                       procedural)
        ts = scene_from_numpy(scene_leaves(js), procedural, device="cpu",
                              dtype=torch.float32)
        for bilinear in ((False, True) if procedural is None else (False,)):
            jcfg = JaxRenderConfig(width=w, height=h, rays_per_pixel=spp,
                                   bounce_limit=bounces, dtype=jnp.float32,
                                   skybox_bilinear=bilinear)
            tcfg = RenderConfig(width=w, height=h, rays_per_pixel=spp,
                                bounce_limit=bounces,
                                skybox_bilinear=bilinear)
            if procedural is None:
                fb_j, rays_j = render_pallas.render_frame_pallas(
                    js, jcfg, interpret=True)
                ref = fb_j.to_array()
                fb, rays = render.render_frame(ts, tcfg)
                name = f"textured t={t} bilinear={bilinear}"
            else:
                color, rays_j = render_pallas._render_rays_pallas(
                    render_pallas.pack_scene(js, jnp.float32),
                    js.skybox.packed.reshape(-1), jcfg, js.spheres.count,
                    js.directional_lights.count, js.point_lights.count,
                    js.skybox.dim, interpret=True, procedural=procedural,
                    accumulate=True)
                ref = np.stack([np.asarray(c).reshape(h, w) for c in color],
                               axis=-1)
                fb, rays = render.render_frame_pixel_rate(ts, tcfg)
                name = f"acc t={t}"
                fb_j, _ = render_pallas.render_frame_pallas(
                    js, jcfg, interpret=True)
                print(f"acc t={t}: JAX's acc frame within "
                      f"{np.abs(np.asarray(fb_j.to_array()) - ref).max():.3g}"
                      " of its render_frame_pallas")
            _stats(name, ref, fb.to_array().numpy(), rays_j, rays)


def knife_shares() -> None:
    g = np.load(chip_smoke.SKY_GOLDEN)
    shares = [float((g[f"k1_{i}"] | g[f"k2_{i}"]).mean())
              for i in range(len(g["times"]))]
    print("image-sky golden knife shares (demo nearest, bilinear; many "
          f"nearest, bilinear; t = 0.7, 3.3): {shares}")


if __name__ == "__main__":
    torch.set_num_threads(1)
    rounding()
    kernels()
    knife_shares()
