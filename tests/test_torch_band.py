"""The demo kernel's band form (``kernels/render.py::render_band``), the
path-tracing kernel's sum mode and the lifted sphere and light caps, on
the CPU through the plain versions.

Bars and tolerances:

- a band x sample slice against JAX's ``render_band_pallas`` in interpret
  mode, ``reduce='sum'`` and ``'avg'``: the knife bar of
  ``tests/knife_util.py`` on the band's values scaled to the frame
  (a sum times 1/N): no u8 flip outside the whole frame's knife-edge
  classes K1 | K2 (the oracle's rows of the band; at most 20% of the
  frame's pixels) or the quantization class KQ, max |d| < 0.5/255 off
  them, median |d| < 2e-5, trace counts within max(0.5%, 16);
- row bands with one sample slice, put together by the sharded renderer's
  combine, equal the whole frame bit for bit, and their trace counts add
  up to the frame's;
- several sample slices a band: within ``SUM_BOUND`` = N * 2^-23 of the
  whole frame (the N-term sample sum reassociated; ``test_torch_sharding``
  derives the bound);
- the path tracer's sum mode against JAX's ``reduce='sum'`` (interpret
  mode): ``chip_smoke.PATHTRACE_BAR``; the sum times float32(1/N) and
  clipped against the mean mode, which divides by N: within one float32
  ulp of 1 (2^-23);
- a demo scene of 70 spheres and 9 + 9 lights against JAX
  ``render_frame``: the knife bar.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from knife_util import (assert_quantized_exact_off_knife, knife_mask,
                        quantize_u8)
from make_torch_golden import (jax_area_lights, jax_frame_seed, jax_scene,
                               scene_leaves)
from ttrt.config import RenderConfig as JaxRenderConfig
from ttrt.kernels.pathtrace_pallas import pathtrace_frame_pallas
from ttrt.kernels.render_pallas import render_band_pallas
from ttrt.render.integrator import render_frame as jax_render_frame
from ttrt.scene import DirectionalLights, Materials, PointLights, Spheres
from ttrt.vec import Vec3 as JVec3

from ttrt_torch.config import ConfigError, RenderConfig
from ttrt_torch.kernels import mesh_fused, pathtrace, render
from ttrt_torch.kernels.render import Band
from ttrt_torch.parallel import sharding
from ttrt_torch.render.pathtrace import AreaLights
from ttrt_torch.scene import scene_from_numpy

torch.set_num_threads(1)  # the test workers share the cores

W, H, N, B = 16, 8, 4, 3
T = 0.7
SUM_BOUND = N * 2.0 ** -23
KNIFE_CAP = 0.20


def _pair(t=T, n=N, bounces=B):
    js = jax_scene(t, W, H)
    ts = scene_from_numpy(scene_leaves(js), "colors", device="cpu",
                          dtype=torch.float32)
    jcfg = JaxRenderConfig(width=W, height=H, rays_per_pixel=n,
                           bounce_limit=bounces, dtype=jnp.float32)
    tcfg = RenderConfig(width=W, height=H, rays_per_pixel=n,
                        bounce_limit=bounces)
    return js, jcfg, ts, tcfg


@pytest.fixture(scope="module")
def knife():
    """The oracle's whole frame and its knife-edge classes K1 | K2."""
    js, jcfg, _, _ = _pair()
    fb, _ = jax_render_frame(js, jcfg, count_rays=True)
    q = quantize_u8(np.asarray(fb.to_array()))
    mask = knife_mask(js, jcfg, q, 3e-6) | knife_mask(js, jcfg, q, 1e-4)
    assert mask.mean() <= KNIFE_CAP  # the frame's share, as the knife bar's
    return mask


def _band_bar(ref, out, knife_rows, rays_ref, rays):
    """The knife bar on a band's values in [0, 1]."""
    ref = np.asarray(ref, np.float64)
    out = np.asarray(out, np.float64)
    flips = quantize_u8(ref) != quantize_u8(out)
    boundary = np.abs(ref * 255 - np.round(ref * 255))
    kq = (boundary < 0.05) & (np.abs(ref - out) * 255 < 0.05)
    uncovered = flips & ~knife_rows[..., None] & ~kq
    assert not uncovered.any(), np.nonzero(uncovered)
    d = np.abs(ref - out)
    assert d[~knife_rows].max() < 0.5 / 255
    assert np.median(d) < 2e-5
    assert abs(rays_ref - rays) <= max(0.005 * rays_ref, 16), (rays_ref, rays)


@pytest.mark.parametrize("i,j", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_band_plain_matches_jax_band(knife, i, j):
    """Band (row i, sample slice j) of a 2x2 split, both reductions."""
    js, jcfg, ts, tcfg = _pair()
    for reduce in ("sum", "avg"):
        band = sharding.band_at(tcfg, 2, 2, i, j, reduce)
        jfb, jrays = render_band_pallas(
            js, jcfg, float(band.row_offset), band.n_rows,
            sample_offset=float(band.sample_offset),
            n_samples=band.n_samples, interpret=True, reduce=reduce)
        fb, rays = render.render_band(
            ts, tcfg, band.row_offset, band.n_rows,
            sample_offset=band.sample_offset, n_samples=band.n_samples,
            reduce=reduce)
        assert fb.x.shape == (band.n_rows, W)
        scale = np.float32(1.0 / N) if reduce == "sum" else np.float32(1)
        rows = slice(band.row_offset, band.row_offset + band.n_rows)
        _band_bar(np.asarray(jfb.to_array()) * scale,
                  fb.to_array().numpy() * scale, knife[rows], int(jrays),
                  int(rays))


def _bands(ts, cfg, n_i, n_j):
    """Every band's sample sum and trace count of an n_i x n_j split."""
    parts, total = {}, 0
    for i in range(n_i):
        for j in range(n_j):
            b = sharding.band_at(cfg, n_i, n_j, i, j)
            fb, rays = render.render_band_plain(
                ts, cfg, b.row_offset, b.n_rows, sample_offset=b.sample_offset,
                n_samples=b.n_samples, reduce="sum")
            parts[(i, j)] = fb
            total += int(rays)
    return parts, total


def test_row_bands_put_together_equal_the_whole_frame():
    """One sample slice a band (S = 1): bit for bit, traces included."""
    _, _, ts, cfg = _pair()
    whole, rays = render.render_frame_plain(ts, cfg)
    want = whole.to_array().numpy()
    for n_i in (1, 2, 4, 8):
        parts, total = _bands(ts, cfg, n_i, 1)
        got = sharding.combine_bands(parts, cfg).to_array().numpy()
        np.testing.assert_array_equal(got, want, err_msg=str(n_i))
        assert total == int(rays)
        band, _ = render.render_band(ts, cfg, 0, H // n_i)
        np.testing.assert_array_equal(band.to_array().numpy(),
                                      want[:H // n_i])


def test_sample_slices_within_the_sum_bound():
    _, _, ts, cfg = _pair()
    whole, rays = render.render_frame_plain(ts, cfg)
    want = whole.to_array().numpy()
    for n_i, n_j in ((2, 2), (1, 2), (1, 4)):
        parts, total = _bands(ts, cfg, n_i, n_j)
        got = sharding.combine_bands(parts, cfg).to_array().numpy()
        assert np.abs(got - want).max() <= SUM_BOUND, (n_i, n_j)
        assert total == int(rays)


def test_band_refusals_and_dispatch():
    _, _, ts, cfg = _pair()
    for kw in ({"row_offset": 6, "n_rows": 4}, {"n_rows": 0},
               {"sample_offset": 3, "n_samples": 2}, {"reduce": "mean"}):
        with pytest.raises(ValueError):
            render.render_band(ts, cfg, **kw)
    assert Band.of(cfg, 2) == Band(2, H - 2, 0, N, "avg")
    counts = (render.render_band_plain.launches,
              render.render_band_cuda.launches)
    render.render_band(ts, cfg, 4, 4, sample_offset=1, n_samples=2,
                       count_rays=False)
    assert (render.render_band_plain.launches,
            render.render_band_cuda.launches) == (counts[0] + 1, counts[1])
    with pytest.raises(ValueError, match="CUDA tensors"):
        render.render_band_cuda(ts, cfg)
    lights = AreaLights.from_numpy(scene_leaves(jax_area_lights()),
                                   dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="reduce"):
        pathtrace.pathtrace_frame(ts, lights, cfg, 7, reduce="avg")
    with pytest.raises(ConfigError, match="spp x bounces"):
        pathtrace.check_supported(
            ts, lights, cfg.with_(rays_per_pixel=4000, bounce_limit=10))


def _pt_pair(t):
    js, jcfg, ts, cfg = _pair(t, n=2)
    lights = AreaLights.from_numpy(scene_leaves(jax_area_lights()),
                                   dtype=torch.float32, device="cpu")
    return js, jcfg, ts, cfg, lights, jax_frame_seed(0, t)


@pytest.mark.parametrize("t", [0.7, 3.3])
def test_pathtrace_sum_matches_jax_sum(t):
    js, jcfg, ts, cfg, lights, seed = _pt_pair(t)
    want = pathtrace_frame_pallas(js, jax_area_lights(), jcfg, seed,
                                  reduce="sum", interpret=True)
    got, work = pathtrace.pathtrace_frame(ts, lights, cfg, seed,
                                          reduce="sum")
    out = got.to_array().numpy()
    assert out.max() > 1.0  # a sum of 2 samples, unclipped
    chip_smoke.pathtrace_bar(np.asarray(want.to_array()), out)
    assert int(work[0]) > 0


def test_pathtrace_sum_scaled_and_clipped_equals_mean():
    _, _, ts, cfg, lights, seed = _pt_pair(0.7)
    total, _ = pathtrace.pathtrace_frame_plain(ts, lights, cfg, seed,
                                               reduce="sum")
    mean, _ = pathtrace.pathtrace_frame_plain(ts, lights, cfg, seed)
    got = sharding.combine_pathtrace([total], cfg).to_array().numpy()
    want = mean.to_array().numpy()
    assert np.abs(got - want).max() <= 2.0 ** -23


def _jax_crowded(js, arrays):
    """The JAX scene ``js`` with ``chip_smoke.crowd_arrays``' spheres and
    lights."""
    v = lambda p: JVec3(*(jnp.asarray(arrays[f"{p}.{c}"])  # noqa: E731
                          for c in "xyz"))
    a = lambda k: jnp.asarray(arrays[k])  # noqa: E731
    return js._replace(
        spheres=Spheres(v("spheres.center"), a("spheres.radius"),
                        Materials(v("spheres.material.color"),
                                  a("spheres.material.reflectivity"),
                                  a("spheres.material.specularity"))),
        directional_lights=DirectionalLights(
            v("directional_lights.direction"), v("directional_lights.color")),
        point_lights=PointLights(v("point_lights.position"),
                                 v("point_lights.color"),
                                 a("point_lights.intensity")))


def test_crowded_scene_plain_matches_jax():
    """70 spheres, 9 directional and 9 point lights, past the kernels' old
    caps (64, 8, 8): every gate takes the scene before the first frame,
    and the plain frame meets the knife bar against JAX ``render_frame``."""
    js, jcfg, ts, cfg = _pair(1.5, n=2, bounces=4)
    ts = chip_smoke.crowd(ts, 70, 9, 9, seed=3)
    js = _jax_crowded(js, chip_smoke.crowd_arrays(70, 9, 9, seed=3))
    assert (ts.spheres.count, ts.directional_lights.count,
            ts.point_lights.count) == (70, 9, 9)
    render.check_supported(ts, cfg)
    lights = AreaLights.from_numpy(scene_leaves(jax_area_lights()),
                                   dtype=torch.float32, device="cpu")
    pathtrace.check_supported(ts, lights, cfg)
    many = {"directional_lights": ts.directional_lights,
            "point_lights": ts.point_lights}
    mesh_fused.check_supported(
        type("Crowded", (), {"clusters": object(), "skybox": ts.skybox,
                             **many})(), cfg)
    want, rays_ref = jax_render_frame(js, jcfg, count_rays=True)
    got, rays = render.render_frame(ts, cfg)
    out = got.to_array().numpy()
    assert out.std() > 0.01
    assert_quantized_exact_off_knife(np.asarray(want.to_array()), out, js,
                                     jcfg, KNIFE_CAP, rays_ref=rays_ref,
                                     rays_pal=int(rays))
