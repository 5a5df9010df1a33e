"""The demo render kernel's two other layouts, on the CPU: the per-ray sky
weights (``sky_weights``, the port of ``_sky_weight_kernel``) and the
pixel-rate frame (``render_frame_pixel_rate``, the port of
``_render_kernel_acc``), each held to the port's own frame and to the JAX
kernel it ports, run in interpret mode; and ``check_ghost_sky``, which
refuses what JAX's ``ghost_sky`` refuses.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import chip_smoke
from make_torch_golden import jax_scene, scene_leaves
from ttrt.assets import (make_colors_skybox, make_starfield_skybox,
                         make_uv_checker_skybox)
from ttrt.config import RenderConfig as JaxRenderConfig
from ttrt.kernels import render_pallas

from ttrt_torch.config import ConfigError, RenderConfig
from ttrt_torch.kernels import render
from ttrt_torch.scene import scene_from_numpy

torch.set_num_threads(1)  # the test workers share the cores

W, H, SPP, BOUNCES = 16, 8, 2, 3


def _pair(t=0.7, sky=make_colors_skybox, dim=16, procedural="colors",
          w=W, h=H, spp=SPP, bounces=BOUNCES, **flags):
    js = jax_scene(t, w, h, sky, dim, procedural)
    ts = scene_from_numpy(scene_leaves(js), procedural, device="cpu",
                          dtype=torch.float32)
    jcfg = JaxRenderConfig(width=w, height=h, rays_per_pixel=spp,
                           bounce_limit=bounces, dtype=jnp.float32, **flags)
    tcfg = RenderConfig(width=w, height=h, rays_per_pixel=spp,
                        bounce_limit=bounces, **flags)
    return js, jcfg, ts, tcfg


def pallas_bar(ref, out, rays_ref, rays):
    """tests/test_torch_render.py's bar against a JAX Pallas kernel."""
    ref = np.asarray(ref, np.float64)
    out = np.asarray(out, np.float64)
    flips = chip_smoke.quantize_u8(ref) != chip_smoke.quantize_u8(out)
    assert flips.any(axis=-1).mean() <= 0.03
    assert float(np.median(np.abs(ref - out))) < 2e-5
    assert float(np.percentile(np.abs(ref - out), 99)) < 1.0 / 255
    assert abs(int(rays_ref) - int(rays)) <= max(0.005 * int(rays_ref), 16)


@pytest.mark.parametrize("sky,dim,procedural,flags", [
    (make_colors_skybox, 16, "colors", {}),
    (make_starfield_skybox, 64, None, {"specular": True,
                                       "energy_model": "subtract"}),
])
def test_sky_weights_equal_the_shaded_chain(sky, dim, procedural, flags):
    """The lighting-free chain's sky weights equal the shaded chain's bit
    for bit, whatever the flags that change only the shading."""
    _, _, ts, tcfg = _pair(2.2, sky, dim, procedural, w=24, h=12,
                           bounces=10, **flags)
    before = render.sky_weights_plain.launches
    w = render.sky_weights(ts, tcfg)
    assert render.sky_weights_plain.launches == before + 1
    assert w.shape == (2, 12, 24) and w.dtype == torch.float32
    chain, _ = render._demo_chain(ts, tcfg)
    assert torch.equal(w.reshape(-1), chain[4])
    assert float(w.max()) > 0.0


def test_sky_weights_meet_jax_kernel():
    """Against JAX's ``_sky_weight_kernel`` in interpret mode, built as
    ``_render_rays_pallas`` builds it (render_pallas.py:1181-1193).
    Exact: at 16x8x2x3, t = 0.7 and 3.3, no ray's weight differs (a ray
    whose chain XLA's approximate rsqrt sent across a knife edge would)."""
    for t in (0.7, 3.3):
        js, jcfg, ts, tcfg = _pair(t)
        packed = render_pallas.pack_scene(js, jnp.float32)
        n_rays = W * H * SPP
        tile = render_pallas.TILE_R * render_pallas.LANES
        n_tiles = pl.cdiv(n_rays, tile)
        smem = pl.BlockSpec(memory_space=pltpu.SMEM)
        out = pl.pallas_call(
            functools.partial(
                render_pallas._sky_weight_kernel, cfg=jcfg,
                n_spheres=js.spheres.count,
                n_dl=js.directional_lights.count,
                n_pl=js.point_lights.count, tile_r=render_pallas.TILE_R,
                n_rows=H, n_samples=SPP),
            grid=(n_tiles,),
            out_shape=jax.ShapeDtypeStruct(
                (n_tiles, render_pallas.TILE_R, render_pallas.LANES),
                jnp.float32),
            in_specs=[smem] * 5,
            out_specs=pl.BlockSpec(
                (1, render_pallas.TILE_R, render_pallas.LANES),
                lambda i: (i, 0, 0), memory_space=pltpu.VMEM),
            interpret=True,
        )(packed.cam, packed.spheres, packed.plane, packed.dlights,
          packed.plights)
        want = np.asarray(out).reshape(-1)[:n_rays].reshape(SPP, H, W)
        got = render.sky_weights(ts, tcfg).numpy()
        assert int((want != got).sum()) == 0, t


@pytest.mark.parametrize("sky,procedural,bilinear,ghost,match", [
    # a procedural sky ignores ghost_sky, whatever its value (:1043)
    (make_colors_skybox, "colors", True, "uv_checker", None),
    # on an image sky: 'colors', nearest, is served
    (make_uv_checker_skybox, None, False, "colors", None),
    (make_uv_checker_skybox, None, True, "colors", "--bilinear"),
    (make_uv_checker_skybox, None, False, "uv_checker", "must be 'colors'"),
])
def test_ghost_sky_refuses_what_jax_refuses(sky, procedural, bilinear,
                                            ghost, match):
    """``check_ghost_sky`` against ``render_frame_pallas(...,
    ghost_sky=...)``: JAX refuses before it traces its kernel, so each
    refusal is checked on both."""
    from ttrt.kernels.render_pallas import render_frame_pallas

    js, jcfg, ts, tcfg = _pair(0.7, sky, 16, procedural,
                               skybox_bilinear=bilinear)
    if match is None:
        render.check_ghost_sky(ts, tcfg, ghost)
        return
    with pytest.raises(ConfigError, match=match):
        render.check_ghost_sky(ts, tcfg, ghost)
    with pytest.raises(ValueError, match=match):
        render_frame_pallas(js, jcfg, interpret=True, ghost_sky=ghost)


@pytest.mark.parametrize("sky,flags", [
    ("colors", {}),
    ("uv_checker", {"skybox_bilinear": True, "specular": True,
                    "energy_model": "subtract"}),
])
def test_pixel_rate_equals_render_frame(sky, flags):
    """The pixel-rate frame is ``render_frame``'s bit for bit, and its
    16|16 per-pixel sums decode to the same trace count."""
    gen = make_colors_skybox if sky == "colors" else make_uv_checker_skybox
    _, _, ts, tcfg = _pair(2.2, gen, 16, sky, w=24, h=12, spp=3,
                           bounces=10, **flags)
    before = render.render_frame_pixel_rate_plain.launches
    fb, rays = render.render_frame_pixel_rate(ts, tcfg)
    assert render.render_frame_pixel_rate_plain.launches == before + 1
    ref, rays_ref = render.render_frame(ts, tcfg)
    assert torch.equal(fb.to_array(), ref.to_array())
    assert int(rays) == int(rays_ref)


def test_pixel_rate_meets_jax_acc_kernel():
    """Against JAX's ``_render_kernel_acc`` in interpret mode, through
    ``_render_rays_pallas(..., accumulate=True)`` (render_pallas.py:
    1059-1107), with tests/test_torch_render.py's Pallas bar. Measured by
    tests/sky_gap.py at 16x8x2x3, t = 0.7: 39 of 128 pixels differ, 99th
    percentile 6.5e-8, one pixel flips (max |d| 0.204: the knife-edge pixel
    of test_torch_render.py's comparison with JAX's sample-rate kernel);
    traces 829 on both. JAX's acc frame is within 6e-8 of its own
    ``render_frame_pallas`` (sum order): the acc kernel works in interpret
    mode."""
    js, jcfg, ts, tcfg = _pair(0.7)
    packed = render_pallas.pack_scene(js, jnp.float32)
    color, rays_acc = render_pallas._render_rays_pallas(
        packed, js.skybox.packed.reshape(-1), jcfg, js.spheres.count,
        js.directional_lights.count, js.point_lights.count, js.skybox.dim,
        interpret=True, procedural="colors", accumulate=True)
    acc = np.stack([np.asarray(c).reshape(H, W) for c in color], axis=-1)
    fb, rays = render.render_frame_pixel_rate(ts, tcfg)
    pallas_bar(acc, fb.to_array().numpy(), rays_acc, rays)


def test_pixel_rate_gates():
    """Procedural skies only, as JAX's acc kernel; spp x bounces within the
    16-bit sums, and sums up to that limit decode in full; CPU tensors
    refused by the CUDA wrappers."""
    _, _, ts, tcfg = _pair(0.7, make_starfield_skybox, 64, None)
    with pytest.raises(ConfigError, match="procedural sky"):
        render.render_frame_pixel_rate(ts, tcfg)
    _, _, ts, tcfg = _pair(0.7)
    with pytest.raises(ConfigError, match="spp x bounces"):
        render.render_frame_pixel_rate(
            ts, tcfg.with_(rays_per_pixel=4097, bounce_limit=16))
    # hits of 0x8000 and more set bit 31 of a pixel's int32 sum
    sums = np.array([0x8000 << 16 | 0xFFFF, 0xFFFF << 16 | 3, 0x7FFF << 16],
                    np.uint32).view(np.int32)
    traces = render.traces_from_pixel_sums(torch.from_numpy(sums), 2)
    assert int(traces) == 0xFFFF + 3 + 2 * (0x8000 + 0xFFFF + 0x7FFF)
    launches = (render.render_frame_pixel_rate_cuda.launches,
                render.sky_weights_cuda.launches)
    for fn in (render.render_frame_pixel_rate_cuda, render.sky_weights_cuda):
        with pytest.raises(ValueError, match="CUDA tensors"):
            fn(ts, tcfg)
    assert launches == (render.render_frame_pixel_rate_cuda.launches,
                        render.sky_weights_cuda.launches)
