"""The fused many-object kernel (``csrc/mesh.cu::mesh_fused_kernel``) on
the card: one thread per (pixel, sample), the quarter boxes staged in
shared memory or read in place. Each launch shape of
``chip_smoke.FUSED_CASES`` (every instantiation the launch can choose)
equals the plain version bit for bit with equal trace counts; one-sample
bands launched together on several streams add up to the frame; the
launch of the full frame fills the card in many waves.
Marked ``cuda``; each test skips without a CUDA device. Run on the card
without the repository's conftest (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_mesh.py
"""

import pytest
import torch

import chip_smoke
from ttrt_torch import assets
from ttrt_torch.config import RenderConfig
from ttrt_torch.frames import orbit_camera_frame
from ttrt_torch.kernels import mesh_fused
from ttrt_torch.mesh.scene import many_sphere_scene

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _scene(n_spheres, cfg, device):
    scene = many_sphere_scene(assets.load_skybox("colors", device=device),
                              n_spheres, cfg.width, cfg.height,
                              dtype=torch.float32, device=device)
    return scene.with_camera_frame(
        orbit_camera_frame(3.3, dtype=torch.float32, device=device))


@pytest.mark.parametrize("case", chip_smoke.FUSED_CASES,
                         ids=[c.key for c in chip_smoke.FUSED_CASES])
def test_fused_kernel_matches_plain_version(cuda, case):
    stats = chip_smoke.fused_case(cuda, case)
    assert stats["max_abs"] == 0.0 and stats["rays"] == stats["rays_ref"]


def test_one_sample_bands_on_streams_sum_to_the_frame(cuda):
    """Ten one-sample sum bands, each launched on its own stream, added in
    sample order from zeros and scaled by 1/10, equal the ten-sample
    launch bit for bit, and their traces add up to its."""
    cfg = RenderConfig(width=97, height=41)
    scene = _scene(2240, cfg, cuda)
    whole, rays = mesh_fused.render_band_mesh_fused_cuda(scene, cfg)
    n = cfg.rays_per_pixel
    streams = [torch.cuda.Stream() for _ in range(n)]
    parts = chip_smoke.on_streams(streams, [
        (lambda k=k: mesh_fused.render_band_mesh_fused_cuda(
            scene, cfg, sample_offset=float(k), n_samples=1, reduce="sum"))
        for k in range(n)])
    torch.cuda.synchronize()
    acc = [torch.zeros_like(c) for c in whole]
    for fb, _ in parts:
        acc = [a + c for a, c in zip(acc, fb)]
    for a, c in zip(acc, whole):
        assert torch.equal(a * (1.0 / n), c)
    assert sum(int(c) for _, c in parts) == int(rays)


def test_full_frame_launch_fills_the_card(cuda):
    """At 480x280x10 and 10,000 spheres a pixel's 10 samples run on 10
    threads of one block, the boxes are staged, and the blocks fill the
    card in several waves, each thread within the launch bounds' 64
    registers."""
    cfg = RenderConfig()
    shape = mesh_fused.fused_layout(_scene(10_000, cfg, cuda), cfg)
    assert shape["sample_threads"] == 10
    p = shape["pixels_per_block"]
    assert shape["threads_per_block"] == 10 * p
    assert (shape["blocks"] - 1) * p < 480 * 280 <= shape["blocks"] * p
    assert shape["boxes_staged"] == 1 and shape["lights_staged"] == 1
    assert shape["waves"] > 2, shape
    assert 0 < shape["registers"] <= 64, shape
