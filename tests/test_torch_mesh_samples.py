"""The invariant the fused kernel's thread mapping rests on, on the CPU.

The CUDA kernel (``csrc/mesh.cu::mesh_fused_kernel``) runs each AA sample
of a pixel on its own thread and adds the samples' colors in sample order
from 0.0f before it scales the sum. Its plain version
(``render_band_mesh_fused_plain``) takes all of a band's samples at once.
So a band's frame has to be the in-order sum, from zeros, of its
one-sample bands (``n_samples=1, reduce='sum'``) times 1/N, bit for bit,
and the trace counts of the one-sample bands have to add up to the
band's. These tests check that on the many-object scene at a small size,
for whole frames, a band of rows and a slice of samples, and hold the
reassembled frame against JAX ``render_frame``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knife_util import assert_quantized_exact_off_knife
from test_torch_mesh import _pair
from ttrt.config import RenderConfig as JaxRenderConfig
from ttrt.render.integrator import render_frame as jax_render_frame

from ttrt_torch.config import RenderConfig
from ttrt_torch.kernels import mesh_fused

torch.set_num_threads(1)  # the test workers share the cores

W, H, SPP, BOUNCES = 24, 12, 4, 4


def _one_sample_sum(scene, cfg, samples, row_offset=0.0, n_rows=None):
    """The in-order sum from zeros of the one-sample sum bands of
    ``samples`` and their trace counts."""
    n_rows = cfg.height if n_rows is None else n_rows
    acc = [torch.zeros((n_rows, cfg.width)) for _ in range(3)]
    traces = 0
    for k in samples:
        fb, count = mesh_fused.render_band_mesh_fused_plain(
            scene, cfg, row_offset, n_rows, sample_offset=float(k),
            n_samples=1, reduce="sum")
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
    _, ts = _pair(200, W, H, procedural=sky)
    cfg = RenderConfig(width=W, height=H, rays_per_pixel=SPP,
                       bounce_limit=BOUNCES, **flags)
    fb, rays = mesh_fused.render_band_mesh_fused_plain(ts, cfg)
    total, traces = _one_sample_sum(ts, cfg, range(SPP))
    assert torch.equal(total * (1.0 / SPP), fb.to_array())
    assert traces == int(rays)


def test_one_sample_bands_sum_to_a_band_of_rows():
    _, ts = _pair(200, W, H)
    cfg = RenderConfig(width=W, height=H, rays_per_pixel=SPP,
                       bounce_limit=BOUNCES)
    fb, rays = mesh_fused.render_band_mesh_fused_plain(ts, cfg, 3.0, 5)
    total, traces = _one_sample_sum(ts, cfg, range(SPP), 3.0, 5)
    assert fb.x.shape == (5, W)
    assert torch.equal(total * (1.0 / SPP), fb.to_array())
    assert traces == int(rays)


@pytest.mark.parametrize("row_offset,n_rows", [(0.0, H), (7.0, 4)])
def test_one_sample_bands_sum_to_a_sample_slice(row_offset, n_rows):
    """Samples 1 and 2 of 4 as one sum band equal their one-sample bands
    added from zeros: no scaling, the slice's own traces."""
    _, ts = _pair(200, W, H)
    cfg = RenderConfig(width=W, height=H, rays_per_pixel=SPP,
                       bounce_limit=BOUNCES)
    fb, rays = mesh_fused.render_band_mesh_fused_plain(
        ts, cfg, row_offset, n_rows, sample_offset=1.0, n_samples=2,
        reduce="sum")
    total, traces = _one_sample_sum(ts, cfg, (1, 2), row_offset, n_rows)
    assert torch.equal(total, fb.to_array())
    assert traces == int(rays)


def test_one_sample_bands_sum_to_an_odd_sample_count():
    """Three samples, which no power-of-two group of sample threads
    divides, on an odd frame."""
    _, ts = _pair(200, 13, 7)
    cfg = RenderConfig(width=13, height=7, rays_per_pixel=3,
                       bounce_limit=BOUNCES)
    fb, rays = mesh_fused.render_band_mesh_fused_plain(ts, cfg)
    total, traces = _one_sample_sum(ts, cfg, range(3))
    assert torch.equal(total * (1.0 / 3), fb.to_array())
    assert traces == int(rays)


def test_one_sample_bands_sum_meets_jax_render_frame():
    """The frame put together from one-sample bands against JAX
    ``render_frame`` on the same scene: the knife bar of
    tests/test_torch_mesh_fused.py and equal trace counts."""
    js, ts = _pair(200, W, H)
    jcfg = JaxRenderConfig(width=W, height=H, rays_per_pixel=SPP,
                           bounce_limit=BOUNCES, dtype=jnp.float32)
    cfg = RenderConfig(width=W, height=H, rays_per_pixel=SPP,
                       bounce_limit=BOUNCES)
    fb_ref, rays_ref = jax_render_frame(js, jcfg, count_rays=True)
    total, traces = _one_sample_sum(ts, cfg, range(SPP))
    out = (total * (1.0 / SPP)).numpy()
    assert out.shape == (H, W, 3) and np.isfinite(out).all()
    assert traces == int(rays_ref)
    assert_quantized_exact_off_knife(np.asarray(fb_ref.to_array()), out, js,
                                     jcfg, knife_cap=0.40)
