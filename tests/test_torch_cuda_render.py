"""The demo render kernel (``csrc/render.cu::render_kernel``) and the
nearest-hit kernel (``csrc/mesh.cu::cluster_nearest_kernel``) on the card.

The render kernel runs one thread per (pixel, sample): each launch shape
of ``chip_smoke.RENDER_CASES`` (with the full frames, every instantiation
the launch can choose) equals the plain version bit for bit with equal
trace counts; one-sample bands launched together on several streams add
up to the frame; the full frame fills the card in several waves within
the launch bounds. The nearest-hit kernel takes packs of any size (its
boxes read in place) and its objects shards merge to the whole pack.
Marked ``cuda``; each test skips without a CUDA device. Run on the card
without the repository's conftest (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_render.py
"""

import pytest
import torch

import chip_smoke
from ttrt_torch import assets
from ttrt_torch.config import RenderConfig
from ttrt_torch.frames import orbit_camera_frame
from ttrt_torch.kernels import mesh, render
from ttrt_torch.parallel import objects
from ttrt_torch.scene import demo_scene

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _demo(cfg, device, t=1.5):
    scene = demo_scene(assets.load_skybox("colors", device=device),
                       cfg.width, cfg.height, dtype=torch.float32,
                       device=device)
    return scene.with_camera_frame(
        orbit_camera_frame(t, dtype=torch.float32, device=device))


@pytest.mark.parametrize("case", chip_smoke.RENDER_CASES,
                         ids=[c.key for c in chip_smoke.RENDER_CASES])
def test_render_kernel_matches_plain_version(cuda, case):
    stats = chip_smoke.render_case(cuda, case)
    assert stats["max_abs"] == 0.0 and stats["rays"] == stats["rays_ref"]


def test_one_sample_bands_on_streams_sum_to_the_frame(cuda):
    """Ten one-sample sum bands, each launched on its own stream, added in
    sample order from zeros and scaled by 1/10, equal the ten-sample
    launch bit for bit, and their traces add up to its."""
    cfg = RenderConfig(width=97, height=41)
    scene = _demo(cfg, cuda)
    whole, rays = render.render_frame_cuda(scene, cfg)
    n = cfg.rays_per_pixel
    streams = [torch.cuda.Stream() for _ in range(n)]
    parts = chip_smoke.on_streams(streams, [
        (lambda k=k: render.render_band_cuda(
            scene, cfg, sample_offset=k, n_samples=1, reduce="sum"))
        for k in range(n)])
    torch.cuda.synchronize()
    acc = [torch.zeros_like(c) for c in whole]
    for fb, _ in parts:
        acc = [a + c for a, c in zip(acc, fb)]
    for a, c in zip(acc, whole):
        assert torch.equal(a * (1.0 / n), c)
    assert sum(int(c) for _, c in parts) == int(rays)


def test_full_frame_launches_fill_the_card(cuda):
    """At 480x280x10 a pixel's 10 samples run on 10 threads of one block,
    the scene is staged, and the blocks fill the card in several waves,
    each thread within the launch bounds' 64 registers; the nearest-hit
    kernel's 1,344,000 rays likewise."""
    cfg = RenderConfig()
    shape = render.render_layout(_demo(cfg, cuda), cfg)
    assert shape["sample_threads"] == 10
    p = shape["pixels_per_block"]
    assert shape["threads_per_block"] == 10 * p
    assert (shape["blocks"] - 1) * p < 480 * 280 <= shape["blocks"] * p
    assert shape["scene_staged"] == 1
    assert shape["waves"] > 2, shape
    assert 0 < shape["registers"] <= 64, shape
    near = mesh.nearest_layout(480 * 280 * 10)
    assert near["waves"] > 2, near
    assert 0 < near["registers"] <= 64 and near["local_bytes"] == 0, near


def test_cluster_nearest_any_pack_size_and_its_shards(cuda):
    """240,000 spheres (a 248,032-byte box table, past a block's shared
    memory) against the dense tester, bit for bit; then the pack in 2
    objects shards, merged, against the whole pack."""
    stats = chip_smoke.nearest_case(cuda, 240_000)
    assert stats["t_diff"] == 0 and stats["id_diff"] == 0, stats
    from ttrt_torch.mesh.scene import many_sphere_scene
    from ttrt_torch.render.integrator import generate_rays
    from ttrt_torch.vec import Vec3

    cfg = RenderConfig(width=64, height=32, rays_per_pixel=2)
    scene = many_sphere_scene(assets.load_skybox("colors", device=cuda),
                              240_000, cfg.width, cfg.height,
                              dtype=torch.float32, device=cuda)
    scene = scene.with_camera_frame(
        orbit_camera_frame(3.3, dtype=torch.float32, device=cuda))
    o, d = generate_rays(scene, cfg)
    o = Vec3(*(c.contiguous() for c in o))
    whole = mesh.cluster_nearest_cuda(scene.clusters, o, d)
    padded = objects.pad_pack_subclusters(scene.clusters.tables, 2)
    merged = objects.merge_nearest(
        [mesh.cluster_nearest_cuda(objects.shard_tables(padded, 2, k), o, d)
         for k in range(2)])
    stats = chip_smoke.nearest_bar(whole, merged)
    assert stats["hits"] > 0
