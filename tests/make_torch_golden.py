"""Write tests/data/torch_port_golden.npz: JAX oracle frames for the port.

The machine with the card has no JAX, so the check of the CUDA kernel
against the JAX oracle (``chip_smoke.py``, phase 3) reads the oracle from
this file. For each scene time in TIMES it holds:

  - ``scene{i}.<field path>``: the JAX Scene's leaves, camera pose
    included, for ``ttrt_torch.scene.scene_from_numpy``;
  - ``fb{i}``: the JAX ``render_frame`` float32 framebuffer, (H, W, 3);
  - ``k1_{i}``, ``k2_{i}``: the knife-edge masks of ``knife_util.knife_mask``
    at eps 3e-6 and 1e-4, (H, W) bool;
  - ``rays{i}``: the oracle's trace count;

plus ``times`` and ``config`` (width, height, spp, bounces).

Run from the repository root:  python tests/make_torch_golden.py
``tests/test_torch_golden.py`` regenerates the arrays in memory and checks
that the stored file equals them.
"""

from __future__ import annotations

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

_TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_TESTS, os.path.dirname(_TESTS)]  # knife_util, ttrt

from knife_util import knife_mask, quantize_u8  # noqa: E402
from ttrt.assets import make_colors_skybox, skybox_from_faces  # noqa: E402
from ttrt.config import RenderConfig  # noqa: E402
from ttrt.frames import orbit_camera_frame  # noqa: E402
from ttrt.render.integrator import render_frame  # noqa: E402
from ttrt.scene import demo_scene  # noqa: E402

GOLDEN_PATH = os.path.join(_TESTS, "data", "torch_port_golden.npz")
WIDTH, HEIGHT, SPP, BOUNCES = 64, 32, 2, 10
TIMES = (0.7, 3.3)
# the 'colors' cubemap is one color per face, so its size changes no frame;
# 16 keeps the stored texels small
SKY_DIM = 16


def scene_leaves(scene) -> dict:
    """A Scene of either package as numpy leaves keyed by field path
    (``"spheres.center.x"``, ``"skybox.packed"``, ...)."""
    out = {}

    def walk(obj, path):
        if hasattr(obj, "_fields"):
            for name in obj._fields:
                walk(getattr(obj, name), f"{path}.{name}" if path else name)
        elif hasattr(obj, "packed"):  # Skybox
            out[f"{path}.packed"] = np.asarray(obj.packed)
        else:
            out[path] = np.asarray(obj)

    walk(scene, "")
    return out


def jax_scene(t: float, width: int = WIDTH, height: int = HEIGHT,
              sky=make_colors_skybox, sky_dim: int = SKY_DIM,
              procedural: str = "colors"):
    """The JAX demo scene with its float32 camera pose at scene time t."""
    scene = demo_scene(
        skybox_from_faces(sky(sky_dim), jnp.float32, procedural=procedural),
        width, height, jnp.float32,
    )
    frame = jax.tree.map(lambda a: a.astype(jnp.float32),
                         orbit_camera_frame(t, jnp.float32))
    return scene.with_camera_frame(frame)


def golden_arrays() -> dict:
    cfg = RenderConfig(width=WIDTH, height=HEIGHT, rays_per_pixel=SPP,
                       bounce_limit=BOUNCES, dtype=jnp.float32)
    out = {
        "times": np.asarray(TIMES, np.float64),
        "config": np.asarray([WIDTH, HEIGHT, SPP, BOUNCES], np.int64),
    }
    for i, t in enumerate(TIMES):
        scene = jax_scene(t)
        fb, rays = render_frame(scene, cfg, count_rays=True)
        ref = np.asarray(fb.to_array(), np.float32)
        q_ref = quantize_u8(ref)
        for key, value in scene_leaves(scene).items():
            out[f"scene{i}.{key}"] = value
        out[f"fb{i}"] = ref
        out[f"k1_{i}"] = knife_mask(scene, cfg, q_ref, 3e-6)
        out[f"k2_{i}"] = knife_mask(scene, cfg, q_ref, 1e-4)
        out[f"rays{i}"] = np.asarray(rays, np.int64)
    return out


if __name__ == "__main__":
    arrays = golden_arrays()
    os.makedirs(os.path.dirname(GOLDEN_PATH), exist_ok=True)
    np.savez_compressed(GOLDEN_PATH, **arrays)
    print(f"wrote {GOLDEN_PATH} ({os.path.getsize(GOLDEN_PATH)} bytes)")
