"""``--skybox`` with an image cubemap through the port's CLI and animation
loop, on the CPU: ``milky_way`` (the starfield that stands in for the
reference's default sky) and a directory of six face PPMs render on both
scenes, nearest and bilinear, through the kernels' plain versions; with
``--pathtrace`` an image sky takes the eager estimator, as in the JAX app
(ttrt/app.py:73-80), since the path-tracing kernel is procedural-only.
"""

import io

import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_app import _run

from ttrt_torch import app, assets, routes
from ttrt_torch.config import ConfigError, RenderConfig
from ttrt_torch.kernels import mesh_fused, pathtrace, render
from ttrt_torch.render import pathtrace as estimator

torch.set_num_threads(1)  # the test workers share the cores

W, H, FRAMES = 24, 8, 2
ARGS = ("--device", "cpu", "--width", str(W), "--height", str(H), "--spp",
        "2", "--bounces", "3", "--frames", str(FRAMES), "--no-input")


@pytest.mark.parametrize("extra", [
    ("--skybox", "milky_way"),
    ("--skybox", "milky_way", "--bilinear", "--scene", "many",
     "--n-spheres", "300"),
])
def test_cli_milky_way_stream(extra):
    proc = _run("-m", "ttrt_torch", *ARGS, *extra)
    assert proc.returncode == 0, proc.stderr.decode()
    chip_smoke.validate_stream(proc.stdout, W, H, FRAMES)


def test_cli_skybox_directory_stream(tmp_path):
    """Six face PPMs (the reference's skybox/<name>/{+X,...}.ppm layout),
    random texels from a seed."""
    rng = np.random.default_rng(7)
    for name in assets.FACE_NAMES:
        assets.write_ppm(str(tmp_path / f"{name}.ppm"),
                         rng.integers(0, 256, (8, 8, 3), dtype=np.uint8))
    sky = assets.load_skybox(str(tmp_path), device="cpu")
    assert sky.procedural is None and sky.dim == 8
    proc = _run("-m", "ttrt_torch", *ARGS, "--skybox", str(tmp_path))
    assert proc.returncode == 0, proc.stderr.decode()
    chip_smoke.validate_stream(proc.stdout, W, H, FRAMES)


@pytest.mark.parametrize("kind", ["demo", "many"])
def test_run_animation_milky_way_through_the_plain_versions(kind):
    """chip_smoke.py phase S4's main paths, on the CPU: every frame goes
    through the scene's kernel (its plain version here) once."""
    cfg = RenderConfig(width=12, height=6, rays_per_pixel=2, bounce_limit=3,
                       frame_rate=1e9)
    scene = app.make_scene(kind, cfg, "milky_way", device="cpu",
                           n_spheres=100)
    assert scene.skybox.procedural is None
    plain = (render.render_frame_plain if kind == "demo"
             else mesh_fused.render_band_mesh_fused_plain)
    before = plain.launches
    sink = io.BytesIO()
    app.run_animation(cfg, "milky_way", max_frames=FRAMES, interactive=False,
                      scene=scene, stream=sink)
    chip_smoke.validate_stream(sink.getvalue(), 12, 6, FRAMES)
    assert plain.launches == before + FRAMES


def test_pathtrace_image_sky_takes_the_estimator(monkeypatch):
    """``--pathtrace --skybox milky_way`` emits a valid stream; in process,
    ``auto`` picks the eager estimator for every frame, no path-tracing
    kernel launch is counted, and ``--renderer kernel`` is refused."""
    proc = _run("-m", "ttrt_torch", *ARGS, "--pathtrace", "--skybox",
                "milky_way")
    assert proc.returncode == 0, proc.stderr.decode()
    chip_smoke.validate_stream(proc.stdout, W, H, FRAMES)

    cfg = RenderConfig(width=8, height=4, rays_per_pixel=1, bounce_limit=2,
                       frame_rate=1e9)
    demo = app.make_scene("demo", cfg, "milky_way", device="cpu")
    lights = estimator.default_area_lights(cfg, "cpu")
    assert routes.pick(demo, cfg, pathtrace=True,
                       lights=lights).name == "estimator"
    with pytest.raises(ConfigError, match="procedural sky"):
        routes.pick(demo, cfg, "kernel", pathtrace=True, lights=lights)
    calls = []
    real = estimator.pathtrace_frame
    monkeypatch.setattr(estimator, "pathtrace_frame",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    before = (pathtrace.pathtrace_frame_plain.launches,
              pathtrace.pathtrace_frame_cuda.launches)
    sink = io.BytesIO()
    app.run_animation(cfg, "milky_way", max_frames=FRAMES, interactive=False,
                      device="cpu", stream=sink, pathtrace=True)
    chip_smoke.validate_stream(sink.getvalue(), 8, 4, FRAMES)
    assert len(calls) == FRAMES
    assert before == (pathtrace.pathtrace_frame_plain.launches,
                      pathtrace.pathtrace_frame_cuda.launches)
