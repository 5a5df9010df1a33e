"""JSON scene files and the physics tier on the card.

A JSON scene (chip_smoke.SCENE_FILE: 9 spheres, two directional lights,
the black stand-in point light) renders through the render kernel, under
a procedural and an image sky, and through the path-tracing kernel, bit
for bit equal to their plain versions with equal traces and work; a
physics frame renders through the render kernel bit for bit too. The
physics step repeats its bits run after run on the card (its pair sums
take a fixed order, no atomics) and equals the CPU run within
chip_smoke.PHYSICS_TOL. Reduced sizes of
chip_smoke.py's phases SF and PH. Marked ``cuda``; each test skips
without a CUDA device. Run on the card without the repository's conftest
(which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_scenes.py
"""

import pytest
import torch

import chip_smoke
from ttrt_torch import assets
from ttrt_torch.config import RenderConfig
from ttrt_torch.frames import orbit_camera_frame
from ttrt_torch.physics import demo
from ttrt_torch.scene import demo_scene
from ttrt_torch.scenefile import scene_from_dict

pytestmark = pytest.mark.cuda

CFG = RenderConfig(width=97, height=41, rays_per_pixel=3, bounce_limit=6)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _file_scene(device, sky, t):
    scene = scene_from_dict({**chip_smoke.SCENE_FILE, "skybox": sky},
                            CFG.width, CFG.height, device=device)
    return scene.with_camera_frame(
        orbit_camera_frame(t, dtype=torch.float32, device=device))


@pytest.mark.parametrize("sky,flags", [("uv_checker", {}),
                                       ("milky_way", {}),
                                       ("milky_way",
                                        {"skybox_bilinear": True})])
def test_scene_file_render_kernel_matches_plain(cuda, sky, flags):
    stats = chip_smoke.file_scene_case(_file_scene(cuda, sky, 2.1),
                                       CFG.with_(**flags))
    assert stats["max_abs"] == 0.0 and stats["rays"] == stats["rays_ref"]


def test_scene_file_pathtrace_kernel_matches_plain(cuda):
    stats = chip_smoke.file_pathtrace_case(_file_scene(cuda, "uv_checker",
                                                       0.7), CFG, 12345)
    assert stats["max_abs"] == 0.0 and stats["work"] == stats["work_ref"]


@pytest.mark.parametrize("name,frames", [("demo", 40), ("head-on", 40)])
def test_physics_repeats_its_bits_on_the_card(cuda, name, frames):
    a, touch_a = chip_smoke.physics_states(name, cuda, frames)
    b, touch_b = chip_smoke.physics_states(name, cuda, frames)
    c, touch_c = chip_smoke.physics_states(name, torch.device("cpu"),
                                           frames)
    assert torch.equal(a, b) and touch_a == touch_b
    assert float((a.cpu() - c).abs().max()) <= chip_smoke.PHYSICS_TOL
    if name == "head-on":
        assert touch_a > 0 and touch_a == touch_c


def test_physics_frame_render_kernel_matches_plain(cuda):
    scene = demo_scene(assets.load_skybox("colors", device=cuda), CFG.width,
                       CFG.height, dtype=torch.float32, device=cuda)
    state, params = demo.build_physics_demo(scene)
    rows, _ = chip_smoke.physics_states("demo", cuda, 45)
    offset = torch.tensor([0.1, -0.2, 0.0], device=cuda)
    for s in (state, chip_smoke.physics_state_of(rows[-1])):
        stats = chip_smoke.physics_frame_case(scene, CFG, params, s, offset)
        assert stats["max_abs"] == 0.0 and stats["rays"] == stats["rays_ref"]
