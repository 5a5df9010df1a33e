"""The CUDA render kernel on the card: against its plain version, against
the stored JAX golden, and its wrapper's checks. Marked ``cuda``; each test
skips without a CUDA device. The machine with the card has no JAX, so run
these without the repository's conftest (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import chip_smoke
from ttrt_torch import assets
from ttrt_torch.config import ConfigError, RenderConfig
from ttrt_torch.frames import orbit_camera_frame
from ttrt_torch.kernels import render
from ttrt_torch.scene import Spheres, demo_scene

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
    cfg = RenderConfig(width=8, height=4, rays_per_pixel=1, bounce_limit=2)
    scene = _scene("colors", 0.0, cfg, cuda)
    n = 65
    rng = np.random.default_rng(5)
    many = Spheres.create(rng.uniform(-1, 1, (n, 3)), np.full(n, 0.1),
                          rng.uniform(0, 1, (n, 3)), 0.5, dtype=torch.float32,
                          device=cuda)
    with pytest.raises(ConfigError, match="at most 64 spheres"):
        render.render_frame_cuda(scene._replace(spheres=many), cfg)
