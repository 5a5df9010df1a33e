"""Write the JAX oracle frames for the port: tests/data/torch_port_golden.npz
(the demo scene), tests/data/torch_port_golden_mesh.npz (the many-object
scene), tests/data/torch_port_golden_pathtrace.npz (the path tracer) and
tests/data/torch_port_golden_sky.npz (both scenes under an image cubemap).

The machine with the card has no JAX, so the checks of the CUDA kernels
against the JAX oracle (``chip_smoke.py``, phases 3, C, P2 and S3) read the
oracle from these files. For each scene time in TIMES a file holds:

  - ``scene{i}.<field path>``: the JAX Scene's (or MeshScene's) leaves,
    camera pose included, for ``ttrt_torch.scene.scene_from_numpy``;
  - ``fb{i}``: the JAX ``render_frame`` float32 framebuffer, (H, W, 3);
  - ``k1_{i}``, ``k2_{i}``: the knife-edge masks of ``knife_util.knife_mask``
    at eps 3e-6 and 1e-4, (H, W) bool;
  - ``rays{i}``: the oracle's trace count;

plus ``times`` and ``config`` (width, height, spp, bounces; the mesh file
adds n_spheres). The path tracer's file holds, for each time, the scene's
leaves, the frame seed ``seed{i}`` (the JAX app's, ttrt/app.py:142-147)
and ``fb{i}``, the JAX kernel's frame (``pathtrace_frame_pallas`` in
interpret mode), plus the area light's leaves ``lights.<field path>``.
The image-sky file holds SKY_FRAMES frames, each of the demo scene or the
many-object scene under the untagged ``make_starfield_skybox(SKY_IMAGE_DIM)``
cubemap, nearest or bilinear, with the demo file's keys per frame (``times``
per frame) and the per-frame flags ``mesh`` and ``bilinear``.

Run from the repository root:  python tests/make_torch_golden.py
[demo|mesh|pathtrace|sky] (all four files without an argument).
``tests/test_torch_golden.py`` regenerates the first two files' arrays in
memory and checks that each stored file equals them (the many-object file
without its knife masks, whose two minutes of JAX renders are too slow for
the tests; the masks are a function of the arrays it does check).
``tests/test_torch_pathtrace_kernel.py`` checks the path tracer's stored
scenes, light and seeds; its frames take a minute of JAX's interpret
mode.
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
from ttrt.assets import (make_colors_skybox,  # noqa: E402
                         make_starfield_skybox, skybox_from_faces)
from ttrt.config import RenderConfig  # noqa: E402
from ttrt.frames import orbit_camera_frame  # noqa: E402
from ttrt.kernels.pathtrace_pallas import (_mix32,  # noqa: E402
                                           pathtrace_frame_pallas)
from ttrt.mesh import many_sphere_scene  # noqa: E402
from ttrt.render.integrator import render_frame  # noqa: E402
from ttrt.render.pathtrace import AreaLights  # noqa: E402
from ttrt.scene import demo_scene  # noqa: E402

GOLDEN_PATH = os.path.join(_TESTS, "data", "torch_port_golden.npz")
MESH_GOLDEN_PATH = os.path.join(_TESTS, "data", "torch_port_golden_mesh.npz")
PT_GOLDEN_PATH = os.path.join(_TESTS, "data",
                              "torch_port_golden_pathtrace.npz")
SKY_GOLDEN_PATH = os.path.join(_TESTS, "data", "torch_port_golden_sky.npz")
WIDTH, HEIGHT, SPP, BOUNCES = 64, 32, 2, 10
TIMES = (0.7, 3.3)
# more than 4 sweep chunks of the JAX fused kernel (tests/test_mesh_fused.py)
MESH_SPHERES = 2240
# the path tracer's golden: 10 bounces, whose interpret-mode compile takes
# about a minute
PT_WIDTH, PT_HEIGHT, PT_SPP, PT_BOUNCES = 64, 32, 4, 10
PT_SEED = 0
# the 'colors' cubemap is one color per face, so its size changes no frame;
# 16 keeps the stored texels small
SKY_DIM = 16
# the image-sky golden's starfield: at 16 texels a face it has no stars
# (int(0.002 * 16 * 16) == 0); at 64 it has 8 a face
SKY_IMAGE_DIM = 64
# (mesh, bilinear, t) of each frame of the image-sky golden
SKY_FRAMES = tuple((mesh, bilinear, t) for mesh in (False, True)
                   for bilinear in (False, True) for t in TIMES)


def scene_leaves(scene) -> dict:
    """A Scene or MeshScene of either package as numpy leaves keyed by
    field path (``"spheres.center.x"``, ``"skybox.packed"``, ...). A
    MeshScene's acceleration structures (grid, cluster pack) are left out:
    the port builds its own pack from the geometry."""
    out = {}
    if hasattr(scene, "clusters"):
        scene = scene._replace(grid=None, clusters=None)

    def walk(obj, path):
        if obj is None:
            return
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


def jax_mesh_scene(t: float, n_spheres: int = MESH_SPHERES,
                   width: int = WIDTH, height: int = HEIGHT, seed: int = 0,
                   floor_cells: int = 16, procedural: str = "colors",
                   sky=make_colors_skybox, sky_dim: int = SKY_DIM):
    """The JAX many-object scene with its float32 camera pose at time t."""
    scene = many_sphere_scene(
        skybox_from_faces(sky(sky_dim), jnp.float32,
                          procedural=procedural),
        n_spheres=n_spheres, width_px=width, height_px=height, seed=seed,
        floor_cells=floor_cells,
    )
    frame = jax.tree.map(lambda a: a.astype(jnp.float32),
                         orbit_camera_frame(t, jnp.float32))
    return scene.with_camera_frame(frame)


def _golden_cfg(**flags) -> RenderConfig:
    return RenderConfig(width=WIDTH, height=HEIGHT, rays_per_pixel=SPP,
                        bounce_limit=BOUNCES, dtype=jnp.float32, **flags)


def _frame(out: dict, i: int, scene, cfg, knife: bool,
           also=None) -> None:
    """Frame ``i`` of a golden into ``out``: the scene's leaves, the
    oracle's frame and trace count and, with ``knife``, its K1/K2 masks;
    ``also``, a (scene, cfg) of the same geometry, adds its masks."""
    fb, rays = render_frame(scene, cfg, count_rays=True)
    ref = np.asarray(fb.to_array(), np.float32)
    for key, value in scene_leaves(scene).items():
        out[f"scene{i}.{key}"] = value
    out[f"fb{i}"] = ref
    if knife:
        masks = [knife_mask(scene, cfg, quantize_u8(ref), eps)
                 for eps in (3e-6, 1e-4)]
        if also is not None:
            s2, c2 = also
            q2 = quantize_u8(np.asarray(render_frame(s2, c2)[0].to_array(),
                                        np.float32))
            masks = [m | knife_mask(s2, c2, q2, eps)
                     for m, eps in zip(masks, (3e-6, 1e-4))]
        out[f"k1_{i}"], out[f"k2_{i}"] = masks
    out[f"rays{i}"] = np.asarray(rays, np.int64)


def _frames(make_scene, config, knife: bool = True) -> dict:
    """The golden's arrays; without ``knife`` the K1/K2 masks (three
    quarters of the time, and a function of the scene, the config and the
    frame) are left out."""
    cfg = _golden_cfg()
    out = {
        "times": np.asarray(TIMES, np.float64),
        "config": np.asarray(config, np.int64),
    }
    for i, t in enumerate(TIMES):
        _frame(out, i, make_scene(t), cfg, knife)
    return out


def golden_arrays() -> dict:
    """The demo scene's golden."""
    return _frames(jax_scene, [WIDTH, HEIGHT, SPP, BOUNCES])


def mesh_golden_arrays(knife: bool = True) -> dict:
    """The many-object scene's golden: MESH_SPHERES spheres, seed 0, the
    16x16-cell floor mesh."""
    return _frames(jax_mesh_scene,
                   [WIDTH, HEIGHT, SPP, BOUNCES, MESH_SPHERES], knife)


def sky_golden_arrays(knife: bool = True) -> dict:
    """The image-sky golden: SKY_FRAMES, the demo scene and the
    MESH_SPHERES-sphere scene under the untagged SKY_IMAGE_DIM starfield,
    nearest and bilinear.

    Each frame's knife masks are the union of its own and those of the
    same geometry under the 'colors' sky (nearest; the demo and mesh
    goldens' masks). The geometry's knife edges do not depend on the sky,
    but which of them the perturbed renders expose does: each sky is
    another XLA program, which contracts other products into fused
    multiply-adds. At t = 0.7 a shadow ray leaves the demo's magenta
    sphere from a point whose c = |p - C|^2 - r^2 rounds to 0.0: there the
    oracle's t0 > 0 (sqrt of the rounded b*b) and the kernels' c > 0
    disagree, and only the 'colors' program's perturbations flip that
    pixel."""
    out = {
        "times": np.asarray([t for _, _, t in SKY_FRAMES], np.float64),
        "mesh": np.asarray([m for m, _, _ in SKY_FRAMES]),
        "bilinear": np.asarray([b for _, b, _ in SKY_FRAMES]),
        "config": np.asarray([WIDTH, HEIGHT, SPP, BOUNCES, MESH_SPHERES,
                              SKY_IMAGE_DIM], np.int64),
    }
    for i, (mesh, bilinear, t) in enumerate(SKY_FRAMES):
        sky = dict(sky=make_starfield_skybox, sky_dim=SKY_IMAGE_DIM,
                   procedural=None)
        scene = (jax_mesh_scene(t, **sky) if mesh
                 else jax_scene(t, WIDTH, HEIGHT, **sky))
        colors = scene._replace(skybox=skybox_from_faces(
            make_colors_skybox(SKY_DIM), jnp.float32, procedural="colors"))
        _frame(out, i, scene, _golden_cfg(skybox_bilinear=bilinear), knife,
               also=(colors, _golden_cfg()))
    return out


def jax_area_lights():
    """The demo's area light (ttrt/app.py:42-53), float32."""
    return AreaLights.create(positions=[[0.0, 3.0, 0.0]], radii=[0.5],
                             colors=[[1.0, 1.0, 1.0]], intensities=[10.0],
                             dtype=jnp.float32)


def jax_frame_seed(seed: int, t: float) -> int:
    """The JAX app's per-frame kernel seed (ttrt/app.py:142-147), with the
    scene time a float32 as the app's jitted step receives it."""
    tq = (jnp.float32(t) * 1000.0).astype(jnp.int32).astype(jnp.uint32)
    return int((_mix32(jnp.uint32(seed) * jnp.uint32(0x9E3779B9))
                ^ tq).astype(jnp.int32))


def pathtrace_golden_arrays() -> dict:
    """The path tracer's golden: the JAX kernel in interpret mode at
    PT_WIDTH x PT_HEIGHT x PT_SPP x PT_BOUNCES, frame seeds of PT_SEED."""
    cfg = RenderConfig(width=PT_WIDTH, height=PT_HEIGHT,
                       rays_per_pixel=PT_SPP, bounce_limit=PT_BOUNCES,
                       dtype=jnp.float32)
    lights = jax_area_lights()
    out = {
        "times": np.asarray(TIMES, np.float64),
        "config": np.asarray([PT_WIDTH, PT_HEIGHT, PT_SPP, PT_BOUNCES],
                             np.int64),
    }
    for key, value in scene_leaves(lights).items():
        out[f"lights.{key}"] = value
    for i, t in enumerate(TIMES):
        scene = jax_scene(t, PT_WIDTH, PT_HEIGHT)
        seed = jax_frame_seed(PT_SEED, t)
        fb = pathtrace_frame_pallas(scene, lights, cfg, seed, interpret=True)
        for key, value in scene_leaves(scene).items():
            out[f"scene{i}.{key}"] = value
        out[f"seed{i}"] = np.asarray(seed, np.int64)
        out[f"fb{i}"] = np.asarray(fb.to_array(), np.float32)
    return out


if __name__ == "__main__":
    which = sys.argv[1:] or ["demo", "mesh", "pathtrace", "sky"]
    for name in which:
        path, arrays = {
            "demo": (GOLDEN_PATH, golden_arrays),
            "mesh": (MESH_GOLDEN_PATH, mesh_golden_arrays),
            "pathtrace": (PT_GOLDEN_PATH, pathtrace_golden_arrays),
            "sky": (SKY_GOLDEN_PATH, sky_golden_arrays),
        }[name]
        os.makedirs(os.path.dirname(path), exist_ok=True)
        np.savez_compressed(path, **arrays())
        print(f"wrote {path} ({os.path.getsize(path)} bytes)")
