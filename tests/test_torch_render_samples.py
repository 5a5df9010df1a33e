"""The invariant the render kernel's thread mapping rests on, on the CPU.

The CUDA kernel (``csrc/render.cu::render_kernel``) runs each AA sample of
a pixel on its own thread and adds the samples' colors in sample order
from 0.0f, carrying the sum between rounds of at most 32 sample threads,
before it scales the sum; it adds the samples' counts as integers. Its
plain version (``render_band_plain``) takes all of a band's samples at
once. So a band's frame has to be the in-order sum, from zeros, of its
one-sample bands (``n_samples=1, reduce='sum'``) times 1/N, bit for bit,
the one-sample bands' trace counts have to add up to the band's, and the
pixel-rate layout's 16|16 sums have to be the sums of the samples'
bounces and hits. These tests check that on the demo scene at a small
size, for whole frames, a band of rows, a slice of samples, an odd sample
count and 33 samples (two rounds), and hold the reassembled frame against
JAX ``render_frame``.
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

from ttrt_torch.config import RenderConfig
from ttrt_torch.kernels import render
from ttrt_torch.scene import scene_from_numpy

torch.set_num_threads(1)  # the test workers share the cores

W, H, SPP, BOUNCES = 24, 12, 4, 6
SKIES = {"colors": make_colors_skybox, "uv_checker": make_uv_checker_skybox}


def _scene(w=W, h=H, sky="colors", t=1.5):
    """The JAX demo scene and the port's scene made from its leaves."""
    js = jax_scene(t, w, h, SKIES[sky], 16, sky)
    return js, scene_from_numpy(scene_leaves(js), sky, device="cpu",
                                dtype=torch.float32)


def _one_sample_sum(scene, cfg, samples, row_offset=0, n_rows=None):
    """The in-order sum from zeros of the one-sample sum bands of
    ``samples`` and their trace counts."""
    n_rows = cfg.height if n_rows is None else n_rows
    acc = [torch.zeros((n_rows, cfg.width)) for _ in range(3)]
    traces = 0
    for k in samples:
        fb, count = render.render_band_plain(
            scene, cfg, row_offset, n_rows, sample_offset=k, n_samples=1,
            reduce="sum")
        acc = [a + c for a, c in zip(acc, fb)]
        traces += int(count)
    return torch.stack(acc, -1), traces


@pytest.mark.parametrize("sky,flags", [
    ("colors", {}),
    ("colors", {"specular": True}),
    ("colors", {"energy_model": "subtract"}),
    ("uv_checker", {"skybox_bilinear": True}),
])
def test_one_sample_bands_sum_to_the_frame(sky, flags):
    _, ts = _scene(sky=sky)
    cfg = RenderConfig(width=W, height=H, rays_per_pixel=SPP,
                       bounce_limit=BOUNCES, **flags)
    fb, rays = render.render_band_plain(ts, cfg)
    total, traces = _one_sample_sum(ts, cfg, range(SPP))
    assert torch.equal(total * (1.0 / SPP), fb.to_array())
    assert traces == int(rays)


def test_one_sample_bands_sum_to_a_band_of_rows():
    _, ts = _scene()
    cfg = RenderConfig(width=W, height=H, rays_per_pixel=SPP,
                       bounce_limit=BOUNCES)
    fb, rays = render.render_band_plain(ts, cfg, 3, 5)
    total, traces = _one_sample_sum(ts, cfg, range(SPP), 3, 5)
    assert fb.x.shape == (5, W)
    assert torch.equal(total * (1.0 / SPP), fb.to_array())
    assert traces == int(rays)


@pytest.mark.parametrize("row_offset,n_rows", [(0, H), (7, 4)])
def test_one_sample_bands_sum_to_a_sample_slice(row_offset, n_rows):
    """Samples 1 and 2 of 4 as one sum band equal their one-sample bands
    added from zeros: no scaling, the slice's own traces."""
    _, ts = _scene()
    cfg = RenderConfig(width=W, height=H, rays_per_pixel=SPP,
                       bounce_limit=BOUNCES)
    fb, rays = render.render_band_plain(ts, cfg, row_offset, n_rows,
                                        sample_offset=1, n_samples=2,
                                        reduce="sum")
    total, traces = _one_sample_sum(ts, cfg, (1, 2), row_offset, n_rows)
    assert torch.equal(total, fb.to_array())
    assert traces == int(rays)


def test_one_sample_bands_sum_to_an_odd_sample_count():
    """Three samples, which no power-of-two group of sample threads
    divides, on an odd frame."""
    _, ts = _scene(13, 7)
    cfg = RenderConfig(width=13, height=7, rays_per_pixel=3,
                       bounce_limit=BOUNCES)
    fb, rays = render.render_band_plain(ts, cfg)
    total, traces = _one_sample_sum(ts, cfg, range(3))
    assert torch.equal(total * (1.0 / 3), fb.to_array())
    assert traces == int(rays)


def test_one_sample_bands_sum_over_two_rounds():
    """33 samples: the kernel's pixel takes them in two rounds of 17 and
    16 sample threads, carrying the first round's sum into the second,
    which is the in-order sum of all 33 from zeros."""
    _, ts = _scene(8, 4)
    cfg = RenderConfig(width=8, height=4, rays_per_pixel=33, bounce_limit=4)
    fb, rays = render.render_band_plain(ts, cfg)
    total, traces = _one_sample_sum(ts, cfg, range(33))
    assert torch.equal(total * (1.0 / 33), fb.to_array())
    assert traces == int(rays)


def test_pixel_rate_sums_are_the_samples_bounces_and_hits():
    """Each sample thread of the pixel-rate kernel counts its bounces |
    hits << 16; their integer sum over the pixel's samples is the 16|16
    pixel sum that ``render_frame_pixel_rate_plain`` decodes."""
    _, ts = _scene()
    cfg = RenderConfig(width=W, height=H, rays_per_pixel=SPP,
                       bounce_limit=BOUNCES)
    sums = torch.zeros((H, W), dtype=torch.int64)
    bounces = torch.zeros_like(sums)
    hits = torch.zeros_like(sums)
    for k in range(SPP):
        band = render.Band.of(cfg, 0, None, k, 1, "sum")
        _, _, count = render._demo_frame(ts, cfg, band)
        b = (count & 0x1F).reshape(H, W).to(torch.int64)
        h = ((count >> 5) & 0x1F).reshape(H, W).to(torch.int64)
        sums += b | (h << 16)
        bounces += b
        hits += h
    assert torch.equal(sums & 0xFFFF, bounces)
    assert torch.equal(sums >> 16, hits)
    fb, rays = render.render_frame_pixel_rate_plain(ts, cfg)
    n_lights = ts.directional_lights.count + ts.point_lights.count
    assert int(rays) == int(render.traces_from_pixel_sums(sums, n_lights))
    total, traces = _one_sample_sum(ts, cfg, range(SPP))
    assert torch.equal(total * (1.0 / SPP), fb.to_array())
    assert traces == int(rays)


def test_one_sample_bands_sum_meets_jax_render_frame():
    """The frame put together from one-sample bands against JAX
    ``render_frame`` on the same scene: the knife bar of
    tests/test_torch_render.py and equal trace counts."""
    js, ts = _scene(t=0.7)
    jcfg = JaxRenderConfig(width=W, height=H, rays_per_pixel=SPP,
                           bounce_limit=BOUNCES, dtype=jnp.float32)
    cfg = RenderConfig(width=W, height=H, rays_per_pixel=SPP,
                       bounce_limit=BOUNCES)
    fb_ref, rays_ref = jax_render_frame(js, jcfg, count_rays=True)
    total, traces = _one_sample_sum(ts, cfg, range(SPP))
    out = (total * (1.0 / SPP)).numpy()
    assert out.shape == (H, W, 3) and np.isfinite(out).all()
    assert_quantized_exact_off_knife(np.asarray(fb_ref.to_array()), out, js,
                                     jcfg, 0.20, int(rays_ref), traces)
