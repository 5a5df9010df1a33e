"""The port's render kernel path against the JAX oracle, on the CPU.

On the CPU ``ttrt_torch.kernels.render.render_frame`` runs the kernel's
plain PyTorch version. It is held to JAX ``render_frame``
(ttrt/render/integrator.py:240) with the knife-edge bar of
``knife_util.assert_quantized_exact_off_knife``: zero u8 flips outside the
enumerated knife-edge classes, sub-quantum agreement elsewhere, trace
counts within max(0.5%, 16). Both sides render the identical scene: the
JAX scene, camera pose included, is carried across by ``scene_from_numpy``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knife_util import assert_quantized_exact_off_knife
from make_torch_golden import jax_scene, scene_leaves
from ttrt.assets import make_colors_skybox, make_uv_checker_skybox
from ttrt.config import RenderConfig as JaxRenderConfig
from ttrt.render.integrator import render_frame as jax_render_frame

import chip_smoke
from ttrt_torch.config import ConfigError, RenderConfig
from ttrt_torch.kernels import render
from ttrt_torch.scene import Skybox, scene_from_numpy

W, H, SPP, BOUNCES = 32, 16, 2, 10


def _pair(sky, t, procedural, **flags):
    js = jax_scene(t, W, H, sky, 16, procedural)
    ts = scene_from_numpy(scene_leaves(js), procedural, device="cpu",
                          dtype=torch.float32)
    jcfg = JaxRenderConfig(width=W, height=H, rays_per_pixel=SPP,
                           bounce_limit=BOUNCES, dtype=jnp.float32, **flags)
    tcfg = RenderConfig(width=W, height=H, rays_per_pixel=SPP,
                        bounce_limit=BOUNCES, **flags)
    return js, jcfg, ts, tcfg


@pytest.mark.parametrize("sky,t,procedural,flags,knife_cap", [
    (make_colors_skybox, 0.7, "colors", {}, 0.20),
    (make_uv_checker_skybox, 3.3, "uv_checker", {}, 0.20),
    (make_colors_skybox, 0.7, "colors", {"energy_model": "subtract"}, 0.25),
])
def test_plain_quantized_exact_off_knife(sky, t, procedural, flags,
                                         knife_cap):
    js, jcfg, ts, tcfg = _pair(sky, t, procedural, **flags)
    fb_ref, rays_ref = jax_render_frame(js, jcfg, count_rays=True)
    before = render.render_frame_plain.launches
    fb, rays = render.render_frame(ts, tcfg)
    assert render.render_frame_plain.launches == before + 1
    assert fb.x.shape == (H, W) and fb.x.dtype == torch.float32
    out = fb.to_array().numpy()
    assert np.isfinite(out).all()
    assert_quantized_exact_off_knife(
        np.asarray(fb_ref.to_array()), out, js, jcfg, knife_cap,
        rays_ref=rays_ref, rays_pal=int(rays))


def test_plain_meets_stored_golden():
    """chip_smoke.py phase 3's check (the CUDA kernel against the stored
    JAX golden), run here with the plain version."""
    for stats in chip_smoke.check_golden(render.render_frame_plain, "cpu"):
        assert stats["uncovered"] == 0


def test_count_rays_false_returns_no_count():
    _, _, ts, tcfg = _pair(make_colors_skybox, 0.7, "colors")
    fb, rays = render.render_frame(ts, tcfg.with_(width=8, height=4),
                                   count_rays=False)
    assert rays is None and fb.x.shape == (4, 8)


def test_specular_and_subtract_change_the_frame():
    _, _, ts, tcfg = _pair(make_colors_skybox, 0.7, "colors")
    base, _ = render.render_frame(ts, tcfg)
    spec, _ = render.render_frame(ts, tcfg.with_(specular=True))
    sub, _ = render.render_frame(ts, tcfg.with_(energy_model="subtract"))
    base = base.to_array().numpy()
    assert np.abs(spec.to_array().numpy() - base).max() > 0.05
    assert np.abs(sub.to_array().numpy() - base).max() > 0.05


@pytest.mark.parametrize("change,match", [
    ({"cfg": {"dtype": torch.float64}}, "float32"),
    ({"cfg": {"skybox_bilinear": True}}, "not yet ported"),
    ({"cfg": {"bounce_limit": 17}}, "bounce_limit"),
    ({"sky": None}, "not yet ported"),
])
def test_render_frame_refuses_unported_configs(change, match):
    _, _, ts, tcfg = _pair(make_colors_skybox, 0.7, "colors")
    tcfg = tcfg.with_(**change.get("cfg", {}))
    if "sky" in change:
        ts = ts._replace(skybox=Skybox(ts.skybox.packed, change["sky"]))
    with pytest.raises(ConfigError, match=match):
        render.render_frame(ts, tcfg)


@pytest.mark.slow
@pytest.mark.parametrize("specular", [False, True])
def test_plain_matches_pallas_interpret(specular):
    """The plain version against the JAX kernel it ports, in interpret
    mode. They differ where XLA's approximate rsqrt and its own fma
    contraction round differently from the port's 1/sqrt and written-out
    fmaf. Measured on this scene (32x16, 2 spp, t=0.7), specular off and
    on alike: max |d| 0.204 on isolated knife-edge pixels, 99th percentile
    2.8e-7 (off) and 1.8e-6 (on), median 0, u8 flips on 0.78% of pixels;
    the Pallas kernel counts 3523 traces, the plain version 3517."""
    from ttrt.kernels.render_pallas import render_frame_pallas

    js, jcfg, ts, tcfg = _pair(make_colors_skybox, 0.7, "colors",
                               specular=specular)
    fb_pal, rays_pal = render_frame_pallas(js, jcfg, interpret=True)
    fb, rays = render.render_frame(ts, tcfg)
    pal = np.asarray(fb_pal.to_array(), np.float64)
    out = fb.to_array().numpy().astype(np.float64)
    flips = (chip_smoke.quantize_u8(pal) != chip_smoke.quantize_u8(out))
    assert flips.any(axis=-1).mean() <= 0.03
    assert float(np.median(np.abs(pal - out))) < 2e-5
    assert float(np.percentile(np.abs(pal - out), 99)) < 1.0 / 255
    assert abs(int(rays_pal) - int(rays)) <= max(0.005 * int(rays_pal), 16)
