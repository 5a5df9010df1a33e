"""The routing of the many-object tier and of ``--pathtrace`` on the CPU:
``python -m ttrt_torch --scene many`` emits a valid stream, ``--renderer
kernel`` refuses a config no kernel serves, ``_pick_renderer`` sends
float64 and ``--renderer eager`` to the integrator, and ``trace_ray_mesh``
gives rays off the CPU to the cluster_nearest kernel or raises.
``--pathtrace`` takes a path-tracing kernel (its plain version here) for
a float32 demo scene or ``MeshScene`` and the eager estimator for
``--renderer eager`` and float64, and refuses what neither serves in one
line.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_app import _run

from ttrt_torch import app
from ttrt_torch.config import ConfigError, RenderConfig
from ttrt_torch import assets
from ttrt_torch.kernels import mesh, mesh_fused, pathtrace
from ttrt_torch.mesh.scene import trace_ray_mesh
from ttrt_torch.render import integrator
from ttrt_torch.render import pathtrace as estimator
from ttrt_torch.vec import Vec3

torch.set_num_threads(1)  # the test workers share the cores


def test_cli_many_scene_stream():
    w, h, frames = 24, 8, 2
    proc = _run("-m", "ttrt_torch", "--device", "cpu", "--scene", "many",
                "--n-spheres", "300", "--width", str(w), "--height", str(h),
                "--spp", "2", "--bounces", "3", "--frames", str(frames),
                "--no-input")
    assert proc.returncode == 0, proc.stderr.decode()
    chip_smoke.validate_stream(proc.stdout, w, h, frames)


def test_cli_kernel_renderer_refuses_f64():
    proc = _run("-m", "ttrt_torch", "--device", "cpu", "--scene", "many",
                "--n-spheres", "50", "--width", "4", "--height", "4",
                "--frames", "1", "--no-input", "--f64", "--renderer",
                "kernel")
    assert proc.returncode == 1
    lines = proc.stderr.decode().strip().splitlines()
    assert len(lines) == 1 and "float32-only" in lines[0], lines


@pytest.mark.parametrize("scene_kind", ["demo", "many"])
def test_pick_renderer_routes(scene_kind):
    cfg = RenderConfig(width=8, height=4, rays_per_pixel=1, bounce_limit=2)
    scene = app.make_scene(scene_kind, cfg, "colors", device="cpu",
                           n_spheres=50)
    kernel = (mesh_fused.render_frame_mesh_fused if scene_kind == "many"
              else app.render.render_frame)
    assert app._pick_renderer(scene, cfg) is kernel
    assert app._pick_renderer(scene, cfg, "kernel") is kernel
    assert app._pick_renderer(scene, cfg, "eager") is integrator.render_frame
    f64 = cfg.with_(dtype=torch.float64)
    assert app._pick_renderer(scene, f64) is integrator.render_frame
    with pytest.raises(ConfigError, match="float32"):
        app._pick_renderer(scene, f64, "kernel")


def test_run_animation_many_scene_through_the_eager_integrator():
    """chip_smoke.py phase E's eager main path, on the CPU: the frames go
    through the integrator (no kernel and no plain kernel version)."""
    import io

    cfg = RenderConfig(width=8, height=4, rays_per_pixel=1, bounce_limit=2,
                       frame_rate=1e9)
    scene = app.make_scene("many", cfg, "colors", device="cpu",
                           n_spheres=50)
    fused = mesh_fused.render_band_mesh_fused_plain.launches
    sink = io.BytesIO()
    app.run_animation(cfg, "colors", max_frames=2, interactive=False,
                      scene=scene, stream=sink, renderer="eager")
    chip_smoke.validate_stream(sink.getvalue(), 8, 4, 2)
    assert mesh_fused.render_band_mesh_fused_plain.launches == fused


def _on_meta(v):
    return Vec3(*(torch.empty(v.x.shape, dtype=v.x.dtype, device="meta")
                  for _ in range(3)))


def test_pick_renderer_refuses_f64_many_scene_off_the_cpu():
    """The card traces a MeshScene through the float32 kernel, so float64
    (the integrator) on a MeshScene is refused off the CPU, before the
    first frame. A ``meta`` tensor stands in for the card here."""
    f64 = RenderConfig(width=8, height=4, rays_per_pixel=1, bounce_limit=2,
                       dtype=torch.float64)
    scene = app.make_scene("many", f64, "colors", device="cpu", n_spheres=50)
    assert app._pick_renderer(scene, f64) is integrator.render_frame
    radius = torch.empty(50, dtype=torch.float64, device="meta")
    off_cpu = scene._replace(spheres=scene.spheres._replace(radius=radius))
    for renderer in ("auto", "eager"):
        with pytest.raises(ConfigError, match="--device cpu"):
            app._pick_renderer(off_cpu, f64, renderer)


def test_trace_ray_mesh_off_the_cpu_takes_the_kernel_or_raises():
    """Rays that are not on the CPU never reach the dense tester: without
    a pack, with float64 rays, or off the card, the trace raises, and no
    kernel launch is counted."""
    cfg = RenderConfig(width=8, height=4, rays_per_pixel=1, bounce_limit=2)
    scene = app.make_scene("many", cfg, "colors", device="cpu", n_spheres=50)
    rng = np.random.default_rng(2)
    o = Vec3(*(torch.from_numpy(rng.normal(size=16).astype(np.float32))
               for _ in range(3)))
    before = mesh.cluster_nearest_cuda.launches
    with pytest.raises(ConfigError, match="cluster pack"):
        trace_ray_mesh(scene._replace(clusters=None), _on_meta(o),
                       _on_meta(o))
    with pytest.raises(ValueError, match="CUDA"):
        trace_ray_mesh(scene, _on_meta(o), _on_meta(o))
    o64 = Vec3(*(c.double() for c in o))
    with pytest.raises(ConfigError, match="float32"):
        mesh.cluster_nearest_cuda(scene.clusters, o64, o64)
    assert mesh.cluster_nearest_cuda.launches == before
    hit = trace_ray_mesh(scene, o, o)  # CPU rays: the dense tester
    assert hit.kind.shape == (16,)


def test_cli_pathtrace_stream_through_the_plain_kernel():
    """``--pathtrace --device cpu`` emits a valid stream; run in process,
    the same frames go through the kernel's plain version, one launch a
    frame."""
    import io

    w, h, frames = 24, 8, 2
    args = ("--width", str(w), "--height", str(h), "--spp", "2",
            "--bounces", "3", "--frames", str(frames), "--no-input")
    proc = _run("-m", "ttrt_torch", "--device", "cpu", "--pathtrace", *args)
    assert proc.returncode == 0, proc.stderr.decode()
    chip_smoke.validate_stream(proc.stdout, w, h, frames)
    cfg = RenderConfig(width=w, height=h, rays_per_pixel=2, bounce_limit=3,
                       frame_rate=1e9)
    before = pathtrace.pathtrace_frame_plain.launches
    sink = io.BytesIO()
    app.run_animation(cfg, "colors", max_frames=frames, interactive=False,
                      device="cpu", stream=sink, pathtrace=True)
    chip_smoke.validate_stream(sink.getvalue(), w, h, frames)
    assert pathtrace.pathtrace_frame_plain.launches == before + frames


def test_cli_pathtrace_refusals_are_one_line():
    for extra, match in [(("--energy-model", "subtract"), "--pathtrace"),
                         (("--bounces", "11"), "--renderer eager")]:
        proc = _run("-m", "ttrt_torch", "--device", "cpu", "--pathtrace",
                    "--width", "4", "--height", "4", "--frames", "1",
                    "--no-input", *extra)
        assert proc.returncode == 1, extra
        lines = proc.stderr.decode().strip().splitlines()
        assert len(lines) == 1 and match in lines[0], lines


def test_pick_pathtracer_routes(monkeypatch):
    """auto: a kernel for a float32 demo scene or MeshScene, the estimator
    for float64; eager: the estimator, also past the kernel's gates
    (--bounces 11), which auto refuses. The estimator's routes run a frame
    each without a kernel launch; the MeshScene's auto route runs one on
    the kernel's plain version."""
    import io

    cfg = RenderConfig(width=8, height=4, rays_per_pixel=1, bounce_limit=2,
                       frame_rate=1e9)
    demo = app.make_scene("demo", cfg, "colors", device="cpu")
    many = app.make_scene("many", cfg, "colors", device="cpu", n_spheres=64)
    lights = estimator.default_area_lights(cfg, "cpu")
    pick = app._pick_pathtracer
    assert pick(demo, lights, cfg) and pick(demo, lights, cfg, "kernel")
    assert not pick(demo, lights, cfg, "eager")
    assert not pick(demo, lights, cfg.with_(dtype=torch.float64))
    assert pick(many, lights, cfg)
    deep = cfg.with_(bounce_limit=11)
    with pytest.raises(ConfigError, match="--renderer eager"):
        pick(demo, lights, deep)
    assert pick(many, lights, cfg, "kernel")
    assert not pick(demo, lights, deep, "eager")

    calls = []
    real = estimator.pathtrace_frame
    monkeypatch.setattr(estimator, "pathtrace_frame",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    before = pathtrace.pathtrace_frame_plain.launches
    for scene, c, renderer in [(demo, deep, "eager"), (many, cfg, "eager"),
                               (many, cfg, "auto")]:
        sink = io.BytesIO()
        app.run_animation(c, "colors", max_frames=1, interactive=False,
                          scene=scene, stream=sink, renderer=renderer,
                          pathtrace=True)
        chip_smoke.validate_stream(sink.getvalue(), 8, 4, 1)
    assert len(calls) == 2
    assert pathtrace.pathtrace_frame_plain.launches == before + 1


def test_cli_still_pathtrace_writes_ppm(tmp_path):
    out = tmp_path / "still.ppm"
    proc = _run("-m", "ttrt_torch", "--device", "cpu", "--pathtrace",
                "--still", str(out), "--width", "20", "--height", "10",
                "--spp", "4", "--time", "1.5", "--seed", "3")
    assert proc.returncode == 0, proc.stderr.decode()
    img = assets.read_ppm(str(out))
    assert img.shape == (10, 20, 3) and img.dtype == np.uint8
    assert img.std() > 0
