"""The routing of the many-object tier on the CPU: ``python -m ttrt_torch
--scene many`` emits a valid stream, ``--renderer kernel`` refuses a
config no kernel serves, ``_pick_renderer`` sends float64 and
``--renderer eager`` to the integrator, and ``trace_ray_mesh`` gives rays
off the CPU to the cluster_nearest kernel or raises.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_app import _run

from ttrt_torch import app
from ttrt_torch.config import ConfigError, RenderConfig
from ttrt_torch.kernels import mesh, mesh_fused
from ttrt_torch.mesh.scene import trace_ray_mesh
from ttrt_torch.render import integrator
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
