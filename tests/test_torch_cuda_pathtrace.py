"""The path-tracing kernel (``csrc/pathtrace.cu::pathtrace_kernel``) and the
sky-weight kernel (``csrc/render.cu::sky_weight_kernel``) on the card.

The path tracer runs one thread per (pixel, sample): each launch shape of
``chip_smoke.PATHTRACE_CASES`` (with the full frames of ``chip_smoke.py``
phases P1 and M2, every instantiation the launch can choose) equals the
plain version bit for bit in both reduce modes, work included, and the
full frame fills the card in several waves within the launch bounds. The
sky weights run one thread per ray: ``chip_smoke.SKY_CASES`` bit for bit,
and the full frame in several waves. The render and fused kernels, which
share the sample-thread reduction, keep their registers and no spill.
Marked ``cuda``; each test skips without a CUDA device. Run on the card
without the repository's conftest (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_pathtrace.py
"""

import pytest
import torch

import chip_smoke
from ttrt_torch import assets
from ttrt_torch.config import RenderConfig
from ttrt_torch.frames import orbit_camera_frame
from ttrt_torch.kernels import mesh_fused, pathtrace, render
from ttrt_torch.render import pathtrace as estimator
from ttrt_torch.scene import demo_scene

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _demo(cfg, device, t=0.7):
    scene = demo_scene(assets.load_skybox("colors", device=device),
                       cfg.width, cfg.height, dtype=torch.float32,
                       device=device)
    return scene.with_camera_frame(
        orbit_camera_frame(t, dtype=torch.float32, device=device))


@pytest.mark.parametrize("case", chip_smoke.PATHTRACE_CASES,
                         ids=[c.key for c in chip_smoke.PATHTRACE_CASES])
def test_pathtrace_kernel_matches_plain_version(cuda, case):
    stats = chip_smoke.pathtrace_case(cuda, case)
    for reduce in pathtrace.REDUCE:
        assert stats[reduce]["max_abs"] == 0.0, stats
        assert stats[reduce]["work"] == stats[reduce]["work_ref"], stats


def _spills(name: str) -> dict:
    """The ptxas spill stores of the ``name`` entries of this build."""
    from ttrt_torch.kernels import build

    return chip_smoke.ptxas_spills(build.build()[1], name)


def test_pathtrace_full_frame_fills_the_card(cuda):
    """At 480x280x10 a pixel's 10 samples run on 10 threads of one block,
    the scene is staged, the blocks take more than one wave, and each
    thread stays within the launch bounds' 64 registers, in both reduce
    modes; ptxas spills nothing in those two instantiations (their local
    memory is the stack of sinf and cosf's slow argument reduction)."""
    cfg = RenderConfig()
    scene = _demo(cfg, cuda)
    lights = estimator.default_area_lights(cfg, cuda)
    for reduce in pathtrace.REDUCE:
        shape = pathtrace.pathtrace_layout(scene, lights, cfg, reduce)
        assert shape["sample_threads"] == 10
        p = shape["pixels_per_block"]
        assert shape["threads_per_block"] == 10 * p
        assert (shape["blocks"] - 1) * p < 480 * 280 <= shape["blocks"] * p
        assert shape["scene_staged"] == 1
        assert shape["waves"] > 1, shape
        assert 0 < shape["registers"] <= 64, shape
    main = {k: v for k, v in _spills("pathtrace_kernel").items()
            if "kernelILb1ELb0ELb0E" in k or "kernelILb1ELb1ELb0E" in k}
    assert len(main) == 2 and not any(main.values()), main


@pytest.mark.parametrize("case", chip_smoke.SKY_CASES,
                         ids=[c.key for c in chip_smoke.SKY_CASES])
def test_sky_weight_kernel_matches_plain_version(cuda, case):
    stats = chip_smoke.sky_case(cuda, case)
    assert stats["diff"] == 0 and stats["max_abs"] == 0.0, stats


def test_sky_weights_full_frame(cuda):
    """480x280x10 at t = 1.5: one thread a ray, bit for bit against the
    plain version, in more than one wave, within 64 registers, with no
    spill in either instantiation."""
    cfg = RenderConfig()
    scene = _demo(cfg, cuda, 1.5)
    w_k = render.sky_weights_cuda(scene, cfg)
    w_p = render.sky_weights_plain(scene, cfg)
    assert torch.equal(w_k, w_p)
    shape = render.sky_weights_layout(scene, cfg)
    assert shape["sample_threads"] == 1 and shape["scene_staged"] == 1
    n = shape["pixels_per_block"]
    assert shape["threads_per_block"] == n
    assert (shape["blocks"] - 1) * n < w_k.numel() <= shape["blocks"] * n
    assert shape["waves"] > 1, shape
    assert 0 < shape["registers"] <= 64 and shape["local_bytes"] == 0, shape
    spills = _spills("sky_weight_kernel")
    assert len(spills) == 2 and not any(spills.values()), spills


def test_render_and_fused_kernels_keep_their_registers(cuda):
    """The sample-thread reduction that the path tracer now shares leaves
    the render kernel's full-frame instantiation at 56 registers and the
    fused kernel's at 64, neither with local memory."""
    from ttrt_torch.mesh.scene import many_sphere_scene

    cfg = RenderConfig()
    shape = render.render_layout(_demo(cfg, cuda, 1.5), cfg)
    assert (shape["registers"], shape["local_bytes"]) == (56, 0), shape
    many = many_sphere_scene(assets.load_skybox("colors", device=cuda),
                             10_000, cfg.width, cfg.height,
                             dtype=torch.float32, device=cuda)
    shape = mesh_fused.fused_layout(many, cfg)
    assert shape["boxes_staged"] == 1, shape
    assert (shape["registers"], shape["local_bytes"]) == (64, 0), shape
