"""The port's eager integrator (``ttrt_torch.render.integrator``: ray
generation, the bounce loop, the AA average, through lighting and
dispatch) against the JAX package on the CPU; its building blocks are in
tests/test_torch_intersect.py.

The integrator is the port's oracle. In float64 it matches JAX
``render_frame`` element-wise, on the demo scene and on a many-object
scene: the tolerance is 1e-9, and the measured max |d| at 24x12, 2 spp,
3 bounces is 1.9e-14 on the demo scene and 1.0e-13 on the many-object
scene (JAX finds the nearest object through its uniform grid and the
reference quadratic, the port through its dense tester and the expanded
one). In float32 it meets the knife-edge bar of ``tests/knife_util.py``
against eager JAX: it equals it bit for bit on the demo scene, and flips 2
knife-edge pixels on the many-object scene (which JAX renders without its
uniform grid, as the port does).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knife_util import assert_quantized_exact_off_knife
from make_torch_golden import SKY_DIM, scene_leaves
from ttrt.assets import make_colors_skybox, skybox_from_faces
from ttrt.config import RenderConfig as JaxRenderConfig
from ttrt.frames import orbit_camera_frame as jax_orbit
from ttrt.mesh import many_sphere_scene as jax_many_sphere_scene
from ttrt.render.integrator import generate_rays as jax_generate_rays
from ttrt.render.integrator import render_frame as jax_render_frame
from ttrt.scene import demo_scene as jax_demo_scene

from ttrt_torch.config import RenderConfig
from ttrt_torch.render import integrator
from ttrt_torch.scene import scene_from_numpy

torch.set_num_threads(1)  # the test workers share the cores

W, H, SPP, BOUNCES = 24, 12, 2, 3
F64_TOL = 1e-9


def _scenes(kind, dtype, t=0.9, procedural="colors"):
    """A JAX scene in ``dtype`` (the demo scene, or 200 spheres over a
    3x3-cell floor) and the port's scene from its leaves."""
    jd = jnp.float64 if dtype == torch.float64 else jnp.float32
    sky = skybox_from_faces(make_colors_skybox(SKY_DIM), jd,
                            procedural=procedural)
    if kind == "demo":
        js = jax_demo_scene(sky, W, H, jd)
    else:
        js = jax_many_sphere_scene(sky, n_spheres=200, width_px=W,
                                   height_px=H, seed=5, dtype=jd,
                                   floor_cells=3)
    frame = jax.tree.map(lambda a: a.astype(jd), jax_orbit(t, jd))
    js = js.with_camera_frame(frame)
    ts = scene_from_numpy(scene_leaves(js), procedural, device="cpu",
                          dtype=dtype)
    return js, ts


def _cfgs(dtype, **flags):
    jd = jnp.float64 if dtype == torch.float64 else jnp.float32
    return (JaxRenderConfig(width=W, height=H, rays_per_pixel=SPP,
                            bounce_limit=BOUNCES, dtype=jd, **flags),
            RenderConfig(width=W, height=H, rays_per_pixel=SPP,
                         bounce_limit=BOUNCES, dtype=dtype, **flags))


def _np(v):
    return np.stack([np.asarray(c) for c in v], axis=-1)


def test_generate_rays_matches_jax_f64():
    js, ts = _scenes("demo", torch.float64)
    jcfg, tcfg = _cfgs(torch.float64)
    jo, jd = jax_generate_rays(js, jcfg)
    to, td = integrator.generate_rays(ts, tcfg)
    np.testing.assert_allclose(_np(to), _np(jo), rtol=0, atol=1e-15)
    np.testing.assert_allclose(_np(td), _np(jd), rtol=0, atol=1e-15)


@pytest.mark.parametrize("kind", ["demo", "many"])
@pytest.mark.parametrize("flags", [{}, {"specular": True},
                                   {"energy_model": "subtract"}])
def test_render_frame_f64_matches_jax(kind, flags):
    js, ts = _scenes(kind, torch.float64)
    jcfg, tcfg = _cfgs(torch.float64, **flags)
    fb_ref, rays_ref = jax_render_frame(js, jcfg, count_rays=True)
    fb, rays = integrator.render_frame(ts, tcfg, count_rays=True)
    assert fb.x.dtype == torch.float64 and fb.x.shape == (H, W)
    ref = np.asarray(fb_ref.to_array(), np.float64)
    out = fb.to_array().numpy()
    assert float(np.abs(ref - out).max()) <= F64_TOL
    assert int(rays) == int(rays_ref)


@pytest.mark.parametrize("kind,cap", [("demo", 0.20), ("many", 0.30)])
def test_render_frame_f32_quantized_exact_off_knife(kind, cap):
    """Against eager JAX: compiled, XLA:CPU contracts products into fused
    multiply-adds that the eager integrator does not write out (the
    kernels' plain versions do). The port has no uniform grid, so JAX
    renders the same grid-less MeshScene (its dense tester, as the port's
    CPU trace)."""
    js, ts = _scenes(kind, torch.float32)
    jcfg, tcfg = _cfgs(torch.float32)
    if kind == "many":
        js = js._replace(grid=None)
    with jax.disable_jit():
        fb_ref, rays_ref = jax_render_frame(js, jcfg, count_rays=True)
    fb, rays = integrator.render_frame(ts, tcfg, count_rays=True)
    out = fb.to_array().numpy()
    assert out.dtype == np.float32 and np.isfinite(out).all()
    assert_quantized_exact_off_knife(
        np.asarray(fb_ref.to_array()), out, js, jcfg, cap,
        rays_ref=rays_ref, rays_pal=int(rays))


def test_count_rays_off_counts_nothing():
    _, ts = _scenes("demo", torch.float32)
    _, tcfg = _cfgs(torch.float32)
    _, rays = integrator.render_frame(ts, tcfg)
    assert int(rays) == 0
