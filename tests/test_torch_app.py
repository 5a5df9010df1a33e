"""The port's CLI and animation loop on the CPU, its isolation from JAX,
and the rule that a device picks its path: the CUDA wrapper raises on CPU
tensors, and CPU tensors go through the plain version."""

import io
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from ttrt_torch import app, assets
from ttrt_torch.config import RenderConfig
from ttrt_torch.kernels import render
from ttrt_torch.scene import demo_scene

torch.set_num_threads(1)  # the test workers share the cores

REPO = Path(__file__).resolve().parent.parent


def _run(*args, timeout=120):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, *args], cwd=REPO, env=env,
                          capture_output=True, timeout=timeout)


def test_cli_animation_stream():
    w, h, frames = 24, 8, 2
    proc = _run("-m", "ttrt_torch", "--device", "cpu", "--width", str(w),
                "--height", str(h), "--spp", "2", "--bounces", "3",
                "--frames", str(frames), "--no-input")
    assert proc.returncode == 0, proc.stderr.decode()
    chip_smoke.validate_stream(proc.stdout, w, h, frames)


def test_cli_still_writes_ppm(tmp_path):
    out = tmp_path / "still.ppm"
    proc = _run("-m", "ttrt_torch", "--device", "cpu", "--still", str(out),
                "--width", "20", "--height", "10", "--spp", "2",
                "--time", "1.5", "--skybox", "uv_checker")
    assert proc.returncode == 0, proc.stderr.decode()
    img = assets.read_ppm(str(out))
    assert img.shape == (10, 20, 3) and img.dtype == np.uint8
    assert img.std() > 0  # spheres, checker ground and sky, not one color


def test_cli_cuda_without_a_card_exits_with_one_error_line():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = _run("-m", "ttrt_torch", "--frames", "1", "--no-input")
    assert proc.returncode != 0
    assert proc.stdout == b""
    lines = proc.stderr.decode().strip().splitlines()
    assert len(lines) == 1 and lines[0].startswith("ttrt_torch: error:")


@pytest.mark.parametrize("args,match", [
    (["--pathtrace", "--renderer", "kernel", "--skybox", "milky_way"],
     "takes a procedural sky"),
    (["--skybox", "no_such_sky"], "Error opening skybox"),
])
def test_cli_refusals_are_one_line(args, match):
    proc = _run("-m", "ttrt_torch", "--device", "cpu", "--frames", "1",
                "--no-input", "--width", "4", "--height", "4", *args)
    assert proc.returncode == 1
    lines = proc.stderr.decode().strip().splitlines()
    assert len(lines) == 1 and match in lines[0], lines


def test_import_leaves_jax_and_ttrt_out():
    code = ("import sys, ttrt_torch.app, ttrt_torch.kernels.build, "
            "ttrt_torch.parallel.mesh, ttrt_torch.parallel.sharding, "
            "ttrt_torch.parallel.objects; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'ttrt.')) or m == 'ttrt']; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = _run("-c", code)
    assert proc.returncode == 0, proc.stdout.decode() + proc.stderr.decode()


def test_package_source_has_no_jax_import_and_no_fallback():
    """No module of the port imports JAX or the JAX package, and no
    ``try`` turns a kernel build or launch failure into another path."""
    banned = re.compile(r"^\s*(import jax|from jax|import ttrt\b(?!_)"
                        r"|from ttrt\b(?!_))", re.M)
    for path in [*(REPO / "ttrt_torch").rglob("*.py"), REPO / "chip_smoke.py"]:
        src = path.read_text()
        assert not banned.search(src), path
    for name in ("kernels/render.py", "kernels/build.py", "kernels/mesh.py",
                 "kernels/mesh_fused.py", "parallel/mesh.py",
                 "parallel/sharding.py", "parallel/objects.py"):
        src = (REPO / "ttrt_torch" / name).read_text()
        assert not re.search(r"^\s*except\b", src, re.M), name


def test_tf32_stays_off_after_main(tmp_path):
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        rc = app.main(["--device", "cpu", "--still",
                       str(tmp_path / "s.ppm"), "--width", "4",
                       "--height", "2", "--spp", "1"])
        assert rc == 0
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is False
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = True


def _cpu_scene(cfg):
    sky = assets.load_skybox("colors", device="cpu")
    return demo_scene(sky, cfg.width, cfg.height, dtype=torch.float32,
                      device="cpu")


def test_cuda_wrapper_raises_on_cpu_tensors():
    cfg = RenderConfig(width=8, height=4, rays_per_pixel=1, bounce_limit=2)
    before = render.render_frame_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        render.render_frame_cuda(_cpu_scene(cfg), cfg)
    assert render.render_frame_cuda.launches == before


def test_cpu_tensors_take_the_plain_version():
    cfg = RenderConfig(width=8, height=4, rays_per_pixel=1, bounce_limit=2)
    kernel, plain = (render.render_frame_cuda.launches,
                     render.render_frame_plain.launches)
    render.render_frame(_cpu_scene(cfg), cfg)
    assert render.render_frame_plain.launches == plain + 1
    assert render.render_frame_cuda.launches == kernel


@pytest.mark.parametrize("encode,pipeline", [("device", 0), ("host", 0),
                                             ("device", 2)])
def test_run_animation_into_a_sink(encode, pipeline):
    """chip_smoke.py phase 5, on the CPU: the loop renders every frame
    once through the device's path and emits a valid ANSI stream."""
    cfg = RenderConfig(width=12, height=6, rays_per_pixel=2, bounce_limit=3,
                       frame_rate=1e9)
    sink = io.BytesIO()
    kernel, plain = (render.render_frame_cuda.launches,
                     render.render_frame_plain.launches)
    timers = app.StageTimers()
    app.run_animation(cfg, "colors", max_frames=3, interactive=False,
                      encode=encode, device="cpu", stream=sink,
                      pipeline=pipeline, timers=timers)
    chip_smoke.validate_stream(sink.getvalue(), cfg.width, cfg.height, 3)
    assert render.render_frame_plain.launches == plain + 3
    assert render.render_frame_cuda.launches == kernel
    assert timers.summary()["encode+write"]["n"] == 3


def test_device_and_host_encode_emit_the_same_frames():
    cfg = RenderConfig(width=10, height=5, rays_per_pixel=2, bounce_limit=3)
    scene = _cpu_scene(cfg)
    dev = app.build_frame_step(scene, cfg, "device")
    host = app.build_frame_step(scene, cfg, "host")
    offset = torch.zeros(3)
    rgb = host(0.4, offset).numpy()
    assert rgb.shape == (5, 10, 3)
    assert dev(0.4, offset).numpy().tobytes() == \
        app.encode_ansi_host(rgb)
