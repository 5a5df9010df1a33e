"""The CUDA kernels on the card: the demo render kernel (whole frames and
bands), the two many-object kernels (fused whole-frame, cluster_nearest on
the whole pack and on objects shards) and the path-tracing kernel (mean
and sum) against their plain versions and the stored JAX goldens, and
their wrappers' checks.
Marked ``cuda``; each test skips without a CUDA device. The machine with
the card has no JAX, so run these without the repository's conftest (which
imports JAX):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import chip_smoke
from ttrt_torch import assets
from ttrt_torch.config import ConfigError, RenderConfig
from ttrt_torch.frames import orbit_camera_frame
from ttrt_torch.kernels import mesh, mesh_fused, pathtrace, render
from ttrt_torch.mesh.dense import dense_nearest
from ttrt_torch.mesh.scene import many_sphere_scene, trace_ray_mesh
from ttrt_torch.parallel import objects, sharding
from ttrt_torch.render.integrator import generate_rays
from ttrt_torch.render.pathtrace import default_area_lights
from ttrt_torch.scene import demo_scene
from ttrt_torch.vec import Vec3

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _scene(sky, t, cfg, device):
    scene = demo_scene(assets.load_skybox(sky, device=device), cfg.width,
                       cfg.height, dtype=torch.float32, device=device)
    return scene.with_camera_frame(
        orbit_camera_frame(t, dtype=torch.float32, device=device))


@pytest.mark.parametrize("sky,flags", [
    ("colors", {}), ("uv_checker", {}), ("colors", {"specular": True}),
    ("colors", {"energy_model": "subtract"}),
])
def test_kernel_matches_plain_version(cuda, sky, flags):
    cfg = RenderConfig(width=97, height=41, rays_per_pixel=3,
                       bounce_limit=10, **flags)
    scene = _scene(sky, 2.2, cfg, cuda)
    before = render.render_frame_cuda.launches
    fb_k, rays_k = render.render_frame(scene, cfg)
    assert render.render_frame_cuda.launches == before + 1
    fb_p, rays_p = render.render_frame_plain(scene, cfg)
    torch.cuda.synchronize()
    chip_smoke.plain_bar(fb_p.to_array().cpu().numpy(),
                         fb_k.to_array().cpu().numpy(), rays_p, rays_k)


def test_kernel_meets_stored_golden(cuda):
    for stats in chip_smoke.check_golden(render.render_frame_cuda, cuda):
        assert stats["uncovered"] == 0


def test_kernel_refuses_too_many_spheres(cuda):
    """No sphere or light count is too many: past 64 spheres and 8 + 8
    lights (a table in shared memory), and past the 48 KB of shared memory
    (read in place), the demo and path-tracing kernels equal their plain
    versions bit for bit."""
    cfg = RenderConfig(width=40, height=24, rays_per_pixel=2, bounce_limit=3)
    lights = default_area_lights(cfg, cuda)
    for n, n_dl, n_pl in ((65, 9, 9), (1400, 1, 1)):
        scene = chip_smoke.crowd(_scene("colors", 1.5, cfg, cuda), n, n_dl,
                                 n_pl, seed=n)
        fb_k, rays_k = render.render_frame_cuda(scene, cfg)
        fb_p, rays_p = render.render_frame_plain(scene, cfg)
        pt_k, work_k = pathtrace.pathtrace_frame_cuda(scene, lights, cfg, 9)
        pt_p, work_p = pathtrace.pathtrace_frame_plain(scene, lights, cfg, 9)
        torch.cuda.synchronize()
        assert torch.equal(fb_k.to_array(), fb_p.to_array()), n
        assert int(rays_k) == int(rays_p)
        assert torch.equal(pt_k.to_array(), pt_p.to_array()), n
        assert work_k.tolist() == work_p.tolist()


def test_bands_and_sum_mode_match_plain_versions(cuda):
    """A band x sample slice of the demo kernel and the path tracer's sum
    mode equal their plain versions bit for bit; bands with one slice put
    together equal the whole frame."""
    cfg = RenderConfig(width=97, height=40, rays_per_pixel=4,
                       bounce_limit=10)
    scene = _scene("colors", 2.2, cfg, cuda)
    b = sharding.band_at(cfg, 2, 2, 1, 1)
    kw = dict(sample_offset=b.sample_offset, n_samples=b.n_samples,
              reduce="sum")
    before = render.render_band_cuda.launches
    fb_k, c_k = render.render_band(scene, cfg, b.row_offset, b.n_rows, **kw)
    assert render.render_band_cuda.launches == before + 1
    fb_p, c_p = render.render_band_plain(scene, cfg, b.row_offset, b.n_rows,
                                         **kw)
    whole, _ = render.render_frame_cuda(scene, cfg)
    parts = {(i, 0): render.render_band_cuda(
        scene, cfg, 10 * i, 10, reduce="sum")[0] for i in range(4)}
    lights = default_area_lights(cfg, cuda)
    pt_k, _ = pathtrace.pathtrace_frame_cuda(scene, lights, cfg, 3,
                                             reduce="sum")
    pt_p, _ = pathtrace.pathtrace_frame_plain(scene, lights, cfg, 3,
                                              reduce="sum")
    torch.cuda.synchronize()
    assert torch.equal(fb_k.to_array(), fb_p.to_array())
    assert int(c_k) == int(c_p)
    assert torch.equal(sharding.combine_bands(parts, cfg).to_array(),
                       whole.to_array())
    assert torch.equal(pt_k.to_array(), pt_p.to_array())


def test_objects_shards_match_the_whole_pack(cuda):
    """cluster_nearest on 2 and 4 objects shards, merged by t then id,
    equals the whole pack's kernel and the plain version on a shard."""
    cfg = RenderConfig(width=64, height=32, rays_per_pixel=2)
    scene = _mesh_scene(0.7, cfg, cuda)
    o, d = generate_rays(scene, cfg)
    whole = mesh.cluster_nearest_cuda(scene.clusters, o, d)
    for n in (2, 4):
        padded = objects.pad_pack_subclusters(scene.clusters.tables, n)
        shards = [objects.shard_tables(padded, n, k) for k in range(n)]
        hits = [mesh.cluster_nearest_cuda(sh, o, d) for sh in shards]
        chip_smoke.nearest_bar(whole, objects.merge_nearest(hits))
        chip_smoke.nearest_bar(mesh.cluster_nearest_plain(shards[-1], o, d),
                               hits[-1])


def _mesh_scene(t, cfg, device, n_spheres=2240, sky="colors"):
    scene = many_sphere_scene(assets.load_skybox(sky, device=device),
                              n_spheres, cfg.width, cfg.height,
                              dtype=torch.float32, device=device)
    return scene.with_camera_frame(
        orbit_camera_frame(t, dtype=torch.float32, device=device))


@pytest.mark.parametrize("flags", [
    {}, {"specular": True}, {"energy_model": "subtract"},
])
def test_mesh_fused_matches_plain_version(cuda, flags):
    """The culled kernel equals the exhaustive plain version bit for bit
    (both keep the lowest id on a tie), trace counts included."""
    cfg = RenderConfig(width=97, height=41, rays_per_pixel=3,
                       bounce_limit=10, **flags)
    scene = _mesh_scene(3.3, cfg, cuda)
    before = mesh_fused.render_band_mesh_fused_cuda.launches
    fb_k, rays_k = mesh_fused.render_frame_mesh_fused(scene, cfg)
    assert mesh_fused.render_band_mesh_fused_cuda.launches == before + 1
    fb_p, rays_p = mesh_fused.render_frame_mesh_fused_plain(scene, cfg)
    torch.cuda.synchronize()
    stats = chip_smoke.exact_bar(fb_p.to_array().cpu().numpy(),
                                 fb_k.to_array().cpu().numpy(), rays_p,
                                 rays_k)
    assert stats["max_abs"] == 0.0, stats


def test_mesh_fused_meets_stored_golden(cuda):
    for stats in chip_smoke.check_golden(
            mesh_fused.render_frame_mesh_fused, cuda,
            chip_smoke.MESH_GOLDEN, chip_smoke.MESH_KNIFE_CAP,
            chip_smoke.MESH_FLIP_CAP):
        assert stats["uncovered"] == 0


def test_cluster_nearest_matches_dense_tester(cuda):
    cfg = RenderConfig(width=64, height=32, rays_per_pixel=1)
    scene = _mesh_scene(0.7, cfg, cuda)
    rng = np.random.default_rng(9)
    o = rng.uniform([-12, -1, -12], [12, 6, 12], (8192, 3))
    d = rng.normal(size=(8192, 3))
    d[:2048, 1] = -np.abs(d[:2048, 1])  # a quarter toward the floor
    to_vec = lambda a: Vec3(*(torch.tensor(a[:, i], dtype=torch.float32,  # noqa: E731
                                           device=cuda) for i in range(3)))
    o, d = to_vec(o), to_vec(d)
    ref = dense_nearest(scene.spheres, scene.triangles, o, d)
    for mode in ("cull", "dense"):
        before = mesh.cluster_nearest_cuda.launches
        out = mesh.cluster_nearest_cuda(scene.clusters, o, d, mode=mode)
        assert mesh.cluster_nearest_cuda.launches == before + 1
        stats = chip_smoke.nearest_bar(ref, out)
        assert stats["hits"] > 1000, (mode, stats)


def test_trace_ray_mesh_on_the_card_takes_the_kernel_or_raises(cuda):
    """Rays on the card go through cluster_nearest_cuda: a scene without
    its pack, or float64 rays, raise instead of falling back."""
    cfg = RenderConfig(width=8, height=4, rays_per_pixel=1)
    scene = _mesh_scene(0.7, cfg, cuda, n_spheres=200)
    o = Vec3(*(torch.zeros(64, device=cuda) for _ in range(3)))
    d = Vec3(torch.ones(64, device=cuda), torch.zeros(64, device=cuda),
             torch.zeros(64, device=cuda))
    before = mesh.cluster_nearest_cuda.launches
    trace_ray_mesh(scene, o, d)
    assert mesh.cluster_nearest_cuda.launches == before + 1
    with pytest.raises(ConfigError, match="cluster pack"):
        trace_ray_mesh(scene._replace(clusters=None), o, d)
    with pytest.raises(ConfigError, match="float32"):
        trace_ray_mesh(scene, Vec3(*(c.double() for c in o)),
                       Vec3(*(c.double() for c in d)))
    assert mesh.cluster_nearest_cuda.launches == before + 1


def test_bilinear_sky_kernels_match_plain_versions(cuda):
    """--bilinear on the 'uv_checker' sky through the demo and the fused
    kernel: the phase-2 bar against the plain versions."""
    cfg = RenderConfig(width=97, height=41, rays_per_pixel=3,
                       bounce_limit=10, skybox_bilinear=True)
    for kernel, plain, scene in [
            (render.render_frame_cuda, render.render_frame_plain,
             _scene("uv_checker", 2.2, cfg, cuda)),
            (mesh_fused.render_frame_mesh_fused,
             mesh_fused.render_frame_mesh_fused_plain,
             _mesh_scene(3.3, cfg, cuda, sky="uv_checker"))]:
        fb_k, rays_k = kernel(scene, cfg)
        fb_p, rays_p = plain(scene, cfg)
        torch.cuda.synchronize()
        chip_smoke.plain_bar(fb_p.to_array().cpu().numpy(),
                             fb_k.to_array().cpu().numpy(), rays_p, rays_k)


def test_pathtrace_kernel_matches_plain_version(cuda):
    """The path-tracing kernel draws its plain version's random stream and
    runs its float operations: equal frames and equal work on the
    'colors' and 'uv_checker' skies, nearest and bilinear."""
    cfg = RenderConfig(width=97, height=41, rays_per_pixel=3,
                       bounce_limit=10)
    lights = default_area_lights(cfg, cuda)
    for sky, bilinear in [("colors", False), ("uv_checker", False),
                          ("uv_checker", True)]:
        c = cfg.with_(skybox_bilinear=bilinear)
        scene = _scene(sky, 2.2, c, cuda)
        seed = pathtrace.frame_seed(5, 2.2)
        before = pathtrace.pathtrace_frame_cuda.launches
        fb_k, work_k = pathtrace.pathtrace_frame(scene, lights, c, seed)
        assert pathtrace.pathtrace_frame_cuda.launches == before + 1
        fb_p, work_p = pathtrace.pathtrace_frame_plain(scene, lights, c,
                                                       seed)
        torch.cuda.synchronize()
        out = fb_k.to_array().cpu().numpy()
        assert np.isfinite(out).all() and 0 <= out.min() <= out.max() <= 1
        np.testing.assert_array_equal(out, fb_p.to_array().cpu().numpy())
        assert work_k.tolist() == work_p.tolist(), (sky, bilinear)


def test_pathtrace_kernel_meets_stored_golden(cuda):
    for stats in chip_smoke.check_pathtrace_golden(
            pathtrace.pathtrace_frame_cuda, cuda):
        assert stats["share"] <= chip_smoke.PT_SHARE


@pytest.mark.parametrize("bilinear", [False, True])
def test_image_sky_kernels_match_plain_versions(cuda, bilinear):
    """The demo and fused kernels under the 'milky_way' image cubemap
    (texels loaded in the kernel): equal to their plain versions bit for
    bit, trace counts included."""
    cfg = RenderConfig(width=97, height=41, rays_per_pixel=3,
                       bounce_limit=10, skybox_bilinear=bilinear)
    for kernel, plain, scene in [
            (render.render_frame, render.render_frame_plain,
             _scene("milky_way", 2.2, cfg, cuda)),
            (mesh_fused.render_frame_mesh_fused,
             mesh_fused.render_frame_mesh_fused_plain,
             _mesh_scene(3.3, cfg, cuda, sky="milky_way"))]:
        assert scene.skybox.procedural is None
        fb_k, rays_k = kernel(scene, cfg)
        fb_p, rays_p = plain(scene, cfg)
        torch.cuda.synchronize()
        stats = chip_smoke.exact_bar(fb_p.to_array().cpu().numpy(),
                                     fb_k.to_array().cpu().numpy(), rays_p,
                                     rays_k)
        assert stats["max_abs"] == 0.0, stats


def test_image_sky_kernels_meet_stored_golden(cuda):
    stats = chip_smoke.check_sky_golden(render.render_frame_cuda,
                                        mesh_fused.render_frame_mesh_fused,
                                        cuda)
    assert len(stats) == 8 and all(s["uncovered"] == 0 for s in stats)


def test_sky_weight_and_pixel_rate_kernels_match_plain_versions(cuda):
    """The sky-weight kernel equals its plain version bit for bit; the
    pixel-rate kernel equals its plain version and the render kernel, trace
    counts included."""
    cfg = RenderConfig(width=97, height=41, rays_per_pixel=3,
                       bounce_limit=10, specular=True)
    scene = _scene("uv_checker", 2.2, cfg, cuda)
    before = (render.sky_weights_cuda.launches,
              render.render_frame_pixel_rate_cuda.launches)
    w = render.sky_weights(scene, cfg)
    fb, rays = render.render_frame_pixel_rate(scene, cfg)
    assert (render.sky_weights_cuda.launches,
            render.render_frame_pixel_rate_cuda.launches) == (
        before[0] + 1, before[1] + 1)
    w_p = render.sky_weights_plain(scene, cfg)
    fb_p, rays_p = render.render_frame_pixel_rate_plain(scene, cfg)
    fb_f, rays_f = render.render_frame_cuda(scene, cfg)
    torch.cuda.synchronize()
    assert w.shape == (3, 41, 97) and torch.equal(w, w_p)
    assert torch.equal(fb.to_array(), fb_p.to_array())
    assert torch.equal(fb.to_array(), fb_f.to_array())
    assert int(rays) == int(rays_p) == int(rays_f)
