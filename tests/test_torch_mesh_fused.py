"""The CUDA kernels' layout of the cluster pack, and the fused
whole-frame kernel's plain version
(``ttrt_torch.kernels.mesh_fused``) against JAX ``render_frame`` on the
CPU, with the bar of tests/test_mesh_fused.py:48-83 (knife_util's
quantized-exact-off-knife bar, exact trace counts); its band and sample
slices, its refusals, and the CUDA wrappers' refusal of CPU tensors.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from knife_util import assert_quantized_exact_off_knife
from test_torch_mesh import _pair, _rays, _tv
from ttrt.config import RenderConfig as JaxRenderConfig
from ttrt.render.integrator import render_frame as jax_render_frame

from ttrt_torch.config import ConfigError, RenderConfig
from ttrt_torch.kernels import mesh, mesh_fused
from ttrt_torch.scene import Skybox

torch.set_num_threads(1)  # the test workers share the cores


def test_kernel_tables_hold_every_object_once():
    """The CUDA kernels' layout: each real object once, in Morton order
    within its quarter, with its quarter's count and a widened box that
    contains it."""
    _, ts = _pair(2240, 16, 8, cells=16)
    tab = ts.clusters.tables
    sph_ids = tab.sph_id[tab.sph_id >= 0]
    tri_ids = tab.tri_id[tab.tri_id >= 0]
    assert sorted(sph_ids.tolist()) == list(range(2240))
    assert sorted(tri_ids.tolist()) == list(range(2240, 2240 + 512))
    n_obj = tab.qbox[:, 6].long()
    assert int(n_obj.sum()) == 2240 + 512
    q_sph = tab.qbox[: 4 * tab.kb_sph]
    c = tab.sph[:, :3].reshape(tab.kb_sph * 4, 32, 3)
    real = (tab.sph_id >= 0).reshape(-1, 32)
    assert torch.equal(real.sum(1), n_obj[: 4 * tab.kb_sph])
    lo, hi = q_sph[:, None, 0:3], q_sph[:, None, 3:6]
    inside = ((c >= lo) & (c <= hi)).all(-1)
    assert bool(inside[real].all())


@pytest.mark.parametrize("n_spheres,w,h,spp,bounces,cells,flags,cap", [
    (200, 24, 12, 2, 3, 3, {}, 0.30),
    (2240, 16, 8, 1, 2, 3, {}, 0.40),
    (200, 24, 12, 2, 2, 3, {"specular": True}, 0.40),
    (200, 24, 12, 2, 3, 3, {"energy_model": "subtract"}, 0.30),
])
def test_fused_plain_quantized_exact_off_knife(n_spheres, w, h, spp,
                                               bounces, cells, flags, cap):
    js, ts = _pair(n_spheres, w, h, cells=cells)
    jcfg = JaxRenderConfig(width=w, height=h, rays_per_pixel=spp,
                           bounce_limit=bounces, dtype=jnp.float32, **flags)
    tcfg = RenderConfig(width=w, height=h, rays_per_pixel=spp,
                        bounce_limit=bounces, **flags)
    fb_ref, rays_ref = jax_render_frame(js, jcfg, count_rays=True)
    before = mesh_fused.render_band_mesh_fused_plain.launches
    fb, rays = mesh_fused.render_frame_mesh_fused(ts, tcfg)
    assert mesh_fused.render_band_mesh_fused_plain.launches == before + 1
    out = fb.to_array().numpy()
    assert out.shape == (h, w, 3) and np.isfinite(out).all()
    assert int(rays) == int(rays_ref)
    assert_quantized_exact_off_knife(np.asarray(fb_ref.to_array()), out, js,
                                     jcfg, knife_cap=cap)


def test_fused_plain_meets_stored_mesh_golden():
    """chip_smoke.py phase C's check, run here with the plain version."""
    for stats in chip_smoke.check_golden(
            mesh_fused.render_frame_mesh_fused_plain, "cpu",
            chip_smoke.MESH_GOLDEN, chip_smoke.MESH_KNIFE_CAP,
            chip_smoke.MESH_FLIP_CAP):
        assert stats["uncovered"] == 0


def test_fused_bands_and_sample_slices_sum_to_the_frame():
    """``render_band_mesh_fused`` with row and sample offsets: the bands'
    rows are the frame's rows, and the sample slices' sums add up to the
    frame times N (the sum-combine of a sharded render)."""
    _, ts = _pair(200, 12, 6, cells=3)
    cfg = RenderConfig(width=12, height=6, rays_per_pixel=3, bounce_limit=3)
    fb, rays = mesh_fused.render_band_mesh_fused(ts, cfg)
    top, r0 = mesh_fused.render_band_mesh_fused(ts, cfg, 0.0, 2)
    bot, r1 = mesh_fused.render_band_mesh_fused(ts, cfg, 2.0, 4)
    band = torch.cat([top.to_array(), bot.to_array()])
    assert torch.equal(band, fb.to_array()) and int(r0 + r1) == int(rays)
    s0, _ = mesh_fused.render_band_mesh_fused(ts, cfg, n_samples=1,
                                              reduce="sum")
    s1, _ = mesh_fused.render_band_mesh_fused(ts, cfg, sample_offset=1.0,
                                              n_samples=2, reduce="sum")
    total = (s0.to_array() + s1.to_array()) * (1.0 / 3)
    np.testing.assert_allclose(total.numpy(), fb.to_array().numpy(),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("change,match", [
    ({"dtype": torch.float64}, "float32"),
    ({"bounce_limit": 17}, "bounce_limit"),
    # image cubemaps render, nearest and bilinear; a tag that names no
    # pattern the kernels evaluate is refused
    ({"skybox_bilinear": True, "sky": "starfield"}, "unknown procedural"),
])
def test_fused_refuses_unported_configs(change, match):
    _, ts = _pair(200, 8, 4, cells=3)
    change = dict(change)
    if "sky" in change:
        ts = ts._replace(skybox=Skybox(ts.skybox.packed, change.pop("sky")))
    cfg = RenderConfig(width=8, height=4, rays_per_pixel=1, bounce_limit=2)
    with pytest.raises(ConfigError, match=match):
        mesh_fused.render_frame_mesh_fused(ts, cfg.with_(**change))
    with pytest.raises(ConfigError, match="cluster pack"):
        mesh_fused.render_frame_mesh_fused(ts._replace(clusters=None), cfg)


def test_cuda_wrappers_raise_on_cpu_tensors():
    _, ts = _pair(200, 8, 4, cells=3)
    cfg = RenderConfig(width=8, height=4, rays_per_pixel=1, bounce_limit=2)
    o, d = _rays(16, 1)
    fused, near = (mesh_fused.render_band_mesh_fused_cuda.launches,
                   mesh.cluster_nearest_cuda.launches)
    with pytest.raises(ValueError, match="CUDA"):
        mesh_fused.render_band_mesh_fused_cuda(ts, cfg)
    with pytest.raises(ValueError, match="CUDA"):
        mesh.cluster_nearest_cuda(ts.clusters, _tv(o), _tv(d))
    assert mesh_fused.render_band_mesh_fused_cuda.launches == fused
    assert mesh.cluster_nearest_cuda.launches == near
