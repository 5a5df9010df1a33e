"""Measure the path-tracing kernel's plain version against JAX's kernel
(``pathtrace_frame_pallas`` in interpret mode) on the CPU, and what the
written-out fused multiply-adds of the path tracer's own arithmetic are
worth: the same frames with ``kernels/pathtrace.py``'s ``_fma`` and
``_dot3`` rounded as written (every product and sum rounded apart).

Run from the repository root:  python tests/pathtrace_gap.py

Prints one line a frame and rounding: chip_smoke.pathtrace_stats (max
|d|, the pixels that differ by more than PT_TOL, their share, the image
means' delta) and the share of rays whose radiance is bit-equal to
JAX's.
"""

import os
import sys

_TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_TESTS, os.path.dirname(_TESTS)]

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from make_torch_golden import (jax_area_lights, jax_frame_seed,  # noqa: E402
                               jax_scene, scene_leaves)
from ttrt.config import RenderConfig as JaxRenderConfig  # noqa: E402
from ttrt.kernels.pathtrace_pallas import (_pathtrace_rays_pallas,  # noqa: E402
                                           pack_area_lights)
from ttrt.kernels.render_pallas import pack_scene  # noqa: E402

from ttrt_torch.config import RenderConfig  # noqa: E402
from ttrt_torch.kernels import pathtrace  # noqa: E402
from ttrt_torch.render.pathtrace import AreaLights  # noqa: E402
from ttrt_torch.scene import scene_from_numpy  # noqa: E402

FUSED = (pathtrace._fma, pathtrace._dot3)
UNFUSED = (lambda a, b, c: a * b + c,
           lambda ax, ay, az, bx, by, bz: ax * bx + ay * by + az * bz)


def jax_rays(js, W, H, N, B, seed):
    """JAX's kernel in interpret mode: per-ray radiance, (3, N*H*W)."""
    cfg = JaxRenderConfig(width=W, height=H, rays_per_pixel=N,
                          bounce_limit=B, dtype=jnp.float32)
    lights = jax_area_lights()
    col = _pathtrace_rays_pallas(
        pack_scene(js, jnp.float32), pack_area_lights(lights, jnp.float32),
        jnp.asarray([seed], jnp.int32), cfg, js.spheres.count,
        lights.count, js.skybox.dim, True, 16, "colors")
    return np.stack([np.asarray(c).reshape(-1)[:N * H * W] for c in col])


def main():
    torch.set_num_threads(4)
    W, H, N, B = 16, 8, 2, 3
    lights = AreaLights.from_numpy(scene_leaves(jax_area_lights()),
                                   dtype=torch.float32, device="cpu")
    for t in (0.7, 3.3):
        js = jax_scene(t, W, H)
        seed = jax_frame_seed(0, t)
        ref = jax_rays(js, W, H, N, B, seed)
        scene = scene_from_numpy(scene_leaves(js), "colors", device="cpu",
                                 dtype=torch.float32)
        cfg = RenderConfig(width=W, height=H, rays_per_pixel=N,
                           bounce_limit=B)
        for name, (fma, dot3) in (("fused", FUSED), ("as written",
                                                       UNFUSED)):
            pathtrace._fma, pathtrace._dot3 = fma, dot3
            try:
                color, _ = pathtrace._paths(scene, lights, cfg, seed)
            finally:
                pathtrace._fma, pathtrace._dot3 = FUSED
            rays = np.stack([c.numpy() for c in color])
            exact = float((rays == ref).all(axis=0).mean())
            frame = lambda r: np.clip(  # noqa: E731
                r.reshape(3, N, H, W).sum(1) / np.float32(N), 0, 1
            ).transpose(1, 2, 0)
            stats = chip_smoke.pathtrace_stats(
                frame(ref), frame(rays))
            print(f"{W}x{H}x{N}x{B} t={t} {name}: rays bit-equal "
                  f"{exact:.4f}, frame {stats}")
    # the stored 10-bounce golden (tests/make_torch_golden.py)
    for name, (fma, dot3) in (("fused", FUSED), ("as written", UNFUSED)):
        pathtrace._fma, pathtrace._dot3 = fma, dot3
        try:
            stats = chip_smoke.check_pathtrace_golden(
                pathtrace.pathtrace_frame_plain, "cpu",
                chip_smoke.pathtrace_stats)
        finally:
            pathtrace._fma, pathtrace._dot3 = FUSED
        print(f"golden {name}: {stats}")


if __name__ == "__main__":
    main()
