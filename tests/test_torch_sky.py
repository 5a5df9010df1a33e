"""Image cubemaps on the port's render paths, on the CPU.

The demo kernel's and the fused kernel's plain versions, under an untagged
(image) cubemap, nearest and bilinear, are held to JAX ``render_frame``
with ``knife_util``'s bar (zero u8 flips outside the knife-edge classes,
equal trace counts), to the stored image-sky golden, and to JAX's textured
Pallas kernel in interpret mode; an untagged 'colors' or 'uv_checker'
cubemap renders bit for bit as the tagged (procedural) one, and a cubemap
far past JAX's dim <= 591 cap is taken.

The starfield (``make_starfield_skybox``, the stand-in for the reference's
``milky_way``) has single-texel stars, so a one-ulp change of direction can
swap a star for the dark sky on one pixel: the knife classes, which
perturb the camera's rotation, cover those texel edges. It needs 64 texels
a face to have stars (8 a face); at 16 it has none.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from knife_util import assert_quantized_exact_off_knife
from make_torch_golden import jax_mesh_scene, jax_scene, scene_leaves
from test_torch_render_variants import pallas_bar
from ttrt.assets import make_starfield_skybox, make_uv_checker_skybox
from ttrt.config import RenderConfig as JaxRenderConfig
from ttrt.render.integrator import render_frame as jax_render_frame

from ttrt_torch import assets
from ttrt_torch.config import RenderConfig
from ttrt_torch.kernels import mesh_fused, render
from ttrt_torch.mesh.scene import many_sphere_scene
from ttrt_torch.scene import Skybox, demo_scene, scene_from_numpy

torch.set_num_threads(1)  # the test workers share the cores

W, H, SPP, BOUNCES = 32, 16, 2, 10


def _cfgs(w, h, spp, bounces, **flags):
    return (JaxRenderConfig(width=w, height=h, rays_per_pixel=spp,
                            bounce_limit=bounces, dtype=jnp.float32, **flags),
            RenderConfig(width=w, height=h, rays_per_pixel=spp,
                         bounce_limit=bounces, **flags))


def _port(js):
    """The port's scene from a JAX scene's leaves, under an image sky."""
    return scene_from_numpy(scene_leaves(js), None, device="cpu",
                            dtype=torch.float32)


@pytest.mark.parametrize("sky,dim,t,bilinear,knife_cap", [
    (make_uv_checker_skybox, 16, 3.3, False, 0.20),
    (make_starfield_skybox, 64, 0.7, False, 0.20),
    (make_starfield_skybox, 64, 3.3, True, 0.30),
    (make_uv_checker_skybox, 16, 1.9, True, 0.30),
])
def test_plain_meets_oracle_off_knife(sky, dim, t, bilinear, knife_cap):
    """The demo kernel's plain version under an image cubemap against JAX
    ``render_frame``. Knife caps: tests/test_pallas_kernel.py's for these
    skies (0.30 for JAX's own textured-bilinear case)."""
    js = jax_scene(t, W, H, sky, dim, None)
    jcfg, tcfg = _cfgs(W, H, SPP, BOUNCES, skybox_bilinear=bilinear)
    fb_ref, rays_ref = jax_render_frame(js, jcfg, count_rays=True)
    before = render.render_frame_plain.launches
    fb, rays = render.render_frame(_port(js), tcfg)
    assert render.render_frame_plain.launches == before + 1
    out = fb.to_array().numpy()
    assert out.shape == (H, W, 3) and np.isfinite(out).all()
    assert int(rays) == int(rays_ref)
    assert_quantized_exact_off_knife(np.asarray(fb_ref.to_array()), out, js,
                                     jcfg, knife_cap)


@pytest.mark.parametrize("bilinear", [False, True])
def test_fused_plain_meets_oracle_off_knife(bilinear):
    """The fused kernel's plain version under the 64-texel starfield
    against JAX ``render_frame``, with tests/test_torch_mesh_fused.py's
    cap for this scene."""
    js = jax_mesh_scene(0.9, 200, 24, 12, 5, 3, None,
                        make_starfield_skybox, 64)
    jcfg, tcfg = _cfgs(24, 12, 2, 3, skybox_bilinear=bilinear)
    fb_ref, rays_ref = jax_render_frame(js, jcfg, count_rays=True)
    before = mesh_fused.render_band_mesh_fused_plain.launches
    fb, rays = mesh_fused.render_frame_mesh_fused(_port(js), tcfg)
    assert mesh_fused.render_band_mesh_fused_plain.launches == before + 1
    out = fb.to_array().numpy()
    assert np.isfinite(out).all() and int(rays) == int(rays_ref)
    assert_quantized_exact_off_knife(np.asarray(fb_ref.to_array()), out, js,
                                     jcfg, knife_cap=0.30)


def test_plain_meets_stored_sky_golden():
    """chip_smoke.py phase S3's check, run here with the plain versions:
    every frame of tests/data/torch_port_golden_sky.npz."""
    stats = chip_smoke.check_sky_golden(
        render.render_frame_plain, mesh_fused.render_frame_mesh_fused_plain,
        "cpu")
    assert len(stats) == 8
    assert all(s["uncovered"] == 0 for s in stats)


@pytest.mark.parametrize("bilinear", [False, True])
def test_plain_meets_pallas_textured_interpret(bilinear):
    """The plain version against JAX's textured ``_render_kernel`` (in
    interpret mode) on the 64-texel starfield, with the bar of
    tests/test_torch_render.py::test_plain_matches_pallas_interpret. JAX's
    kernel folds the image sky in a jitted epilogue, where XLA:CPU
    multiplies by 1/255 and contracts the bilinear lerps and the fold; the
    port follows the eager oracle, so every sky term may differ by an ulp,
    on top of the direction noise of XLA's approximate rsqrt (under the
    procedural 'colors' sky, where the sky terms are exact 0s and 1s, the
    99th percentile is 2.8e-7, tests/test_torch_render.py). Measured by
    tests/sky_gap.py at 16x8x2x3, t = 1.3: nearest 73 and bilinear 86 of
    128 pixels differ, max |d| 5.3e-7 and 5.4e-7, 99th percentile 1.5e-7
    and 2.7e-7, no u8 flip; traces 868 on both."""
    from ttrt.kernels.render_pallas import render_frame_pallas

    js = jax_scene(1.3, 16, 8, make_starfield_skybox, 64, None)
    jcfg, tcfg = _cfgs(16, 8, 2, 3, skybox_bilinear=bilinear)
    fb_pal, rays_pal = render_frame_pallas(js, jcfg, interpret=True)
    fb, rays = render.render_frame(_port(js), tcfg)
    pallas_bar(fb_pal.to_array(), fb.to_array().numpy(), rays_pal, rays)


def test_untagged_procedural_skies_render_bit_for_bit():
    """An untagged 'colors' or 'uv_checker' cubemap (texels loaded and
    divided by 255) renders exactly as the tagged one (the pattern replayed
    in place), nearest and bilinear, through both plain versions: the two
    paths divide by 255 the same way (JAX's
    test_procedural_sky_matches_textured_exactly, on the port)."""
    cfg = RenderConfig(width=24, height=12, rays_per_pixel=2,
                       bounce_limit=6)
    for name in ("colors", "uv_checker"):
        tagged = assets.load_skybox(name, device="cpu")
        assert tagged.procedural == name
        untagged = Skybox(tagged.packed, None)
        for bilinear in (False, True):
            c = cfg.with_(skybox_bilinear=bilinear)
            outs = []
            for sky in (tagged, untagged):
                demo = demo_scene(sky, c.width, c.height,
                                  dtype=torch.float32, device="cpu")
                many = many_sphere_scene(sky, 64, c.width, c.height,
                                         dtype=torch.float32, device="cpu")
                outs.append([render.render_frame(demo, c),
                             mesh_fused.render_frame_mesh_fused(many, c)])
            for (fb_t, rays_t), (fb_u, rays_u) in zip(*outs):
                assert torch.equal(fb_t.to_array(), fb_u.to_array()), (
                    name, bilinear)
                assert int(rays_t) == int(rays_u)


def test_large_cubemap_is_taken():
    """A 600-texel cubemap, past JAX's textured cap of 591, passes the
    kernels' gates, and the plain version meets the knife bar against JAX
    ``render_frame`` (which has no cap)."""
    js = jax_scene(1.5, 16, 8, make_starfield_skybox, 600, None)
    jcfg, tcfg = _cfgs(16, 8, 2, 3)
    ts = _port(js)
    assert ts.skybox.dim == 600
    render.check_supported(ts, tcfg)
    mesh_fused.check_supported(
        many_sphere_scene(ts.skybox, 50, 16, 8, dtype=torch.float32,
                          device="cpu"), tcfg)
    fb_ref, rays_ref = jax_render_frame(js, jcfg, count_rays=True)
    fb, rays = render.render_frame(ts, tcfg)
    assert int(rays) == int(rays_ref)
    assert_quantized_exact_off_knife(np.asarray(fb_ref.to_array()),
                                     fb.to_array().numpy(), js, jcfg, 0.20)
