"""The routing of the many-object tier and of ``--pathtrace`` on the CPU:
``python -m ttrt_torch --scene many`` emits a valid stream, ``--renderer
kernel`` refuses a config no kernel serves, ``routes.pick`` sends
float64 and ``--renderer eager`` to the integrator (every row of its route
table: the leaf, the graph flag, the refusal), and ``trace_ray_mesh``
gives rays off the CPU to the cluster_nearest kernel or raises.
``--pathtrace`` takes a path-tracing kernel (its plain version here) for
a float32 demo scene or ``MeshScene`` and the eager estimator for
``--renderer eager`` and float64, and refuses what neither serves in one
line.
"""

import math
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_app import _run

from ttrt_torch import app, routes
from ttrt_torch.config import ConfigError, RenderConfig
from ttrt_torch import assets
from ttrt_torch.kernels import mesh, mesh_fused, pathtrace, render
from ttrt_torch.parallel import objects, sharding
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


def _stand_in_mesh(**axes):
    """A device mesh as the router reads one: its axes, their sizes, its
    size."""
    return SimpleNamespace(mesh_dim_names=tuple(axes),
                           mesh=torch.zeros(tuple(axes.values())),
                           size=lambda: math.prod(axes.values()))


# each route's leaves: (single device, over a mesh)
LEAVES = {
    "eager": (integrator.render_frame, sharding.render_frame_sharded),
    "demo kernel": (render.render_frame,
                    sharding.render_frame_sharded_kernel),
    "fused kernel": (mesh_fused.render_frame_mesh_fused,
                     sharding.render_frame_sharded_mesh_fused),
    "objects": (None, objects.render_frame_sharded_objects),
    "pathtrace kernel": (pathtrace.pathtrace_frame,
                         sharding.pathtrace_frame_sharded_kernel),
    "estimator": (estimator.pathtrace_frame,
                  sharding.pathtrace_frame_sharded),
}
F32 = "float32-only"
PT_MESH = "path-tracing kernel only .--renderer eager"
SAMPLES = "--pathtrace shards samples, not geometry"
# (scene, mesh axes): {(path tracing, float64): the route or the refusal
# of auto, kernel and eager}
ROUTE_TABLE = {
    ("demo", None): {
        (False, False): ("demo kernel", "demo kernel", "eager"),
        (False, True): ("eager", "render kernel is " + F32, "eager"),
        (True, False): ("pathtrace kernel", "pathtrace kernel", "estimator"),
        (True, True): ("estimator", F32 + " .--renderer eager", "estimator"),
    },
    ("many", None): {
        (False, False): ("fused kernel", "fused kernel", "eager"),
        (False, True): ("eager", "fused mesh kernel is " + F32, "eager"),
        (True, False): ("pathtrace kernel", "pathtrace kernel", "estimator"),
        (True, True): ("estimator", F32 + " .--renderer eager", "estimator"),
    },
    ("demo", "rows"): {
        (False, False): ("demo kernel", "demo kernel", "eager"),
        (False, True): ("eager", "render kernel is " + F32, "eager"),
        (True, False): ("pathtrace kernel", "pathtrace kernel", "estimator"),
        (True, True): ("estimator", F32 + " .--renderer eager", "estimator"),
    },
    ("many", "rows"): {
        (False, False): ("fused kernel", "fused kernel", "eager"),
        (False, True): ("eager", "fused mesh kernel is " + F32, "eager"),
        (True, False): ("estimator", PT_MESH, "estimator"),
        (True, True): ("estimator", PT_MESH, "estimator"),
    },
    ("demo", "objects"): {
        (False, False): ("needs a cluster-packed",) * 3,
        (False, True): ("needs a cluster-packed",) * 3,
        (True, False): (SAMPLES,) * 3,
        (True, True): (SAMPLES, F32 + " .--renderer eager", SAMPLES),
    },
    ("many", "objects"): {
        (False, False): ("objects",) * 3,
        (False, True): ("--f64 is refused with it",) * 3,
        (True, False): (SAMPLES, PT_MESH, SAMPLES),
        (True, True): (SAMPLES, PT_MESH, SAMPLES),
    },
}


@pytest.mark.parametrize("scene_kind,axes", [
    pytest.param(*case, id="-".join(c for c in case if c))
    for case in ROUTE_TABLE])
def test_pick_renderer_routes(monkeypatch, scene_kind, axes):
    """Every row of the route table: the route ``routes.pick`` names, the
    leaf its frame calls (the single device's, or the mesh's with the
    mesh), whether it may be graphed (a kernel's, on one device), or the
    refusal. The mesh is a stand-in: 2 rows, or 2 on the objects axis."""
    cfg = RenderConfig(width=8, height=4, rays_per_pixel=2, bounce_limit=2)
    scene = app.make_scene(scene_kind, cfg, "colors", device="cpu",
                           n_spheres=50)
    mesh = {None: None, "rows": _stand_in_mesh(rows=2, samples=1),
            "objects": _stand_in_mesh(rows=1, samples=1, objects=2)}[axes]
    called = []  # (the leaf, whether it was given the mesh)

    def stub(leaf):
        def call(*args, **kw):
            called.append((leaf, mesh is not None and any(
                x is mesh for x in (*args, *kw.values()))))
            return None, None
        return call

    for leaf in (f for pair in LEAVES.values() for f in pair if f):
        monkeypatch.setattr(sys.modules[leaf.__module__], leaf.__name__,
                            stub(leaf))
    for (path, f64), want in ROUTE_TABLE[scene_kind, axes].items():
        c = cfg.with_(dtype=torch.float64) if f64 else cfg
        for renderer, expect in zip(routes.RENDERERS, want):
            row = (path, f64, renderer)

            def pick():
                return routes.pick(scene, c, renderer, mesh=mesh,
                                   pathtrace=path, seed=3)

            if expect not in LEAVES:
                with pytest.raises(ConfigError, match=expect):
                    pick()
                continue
            route = pick()
            assert route.name == expect, row
            assert route.graphable == (
                mesh is None and expect in ("demo kernel", "fused kernel"))
            assert (route.fn is None) == path, row
            called.clear()
            route.frame(scene, 0.5)
            leaf = LEAVES[expect][mesh is not None]
            assert called == [(leaf, mesh is not None)], row
    with pytest.raises(ConfigError, match="unknown renderer"):
        routes.pick(scene, cfg, "fast", mesh=mesh)


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
    assert routes.pick(scene, f64).fn is integrator.render_frame
    radius = torch.empty(50, dtype=torch.float64, device="meta")
    off_cpu = scene._replace(spheres=scene.spheres._replace(radius=radius))
    for renderer in ("auto", "eager"):
        with pytest.raises(ConfigError, match="--device cpu"):
            routes.pick(off_cpu, f64, renderer)


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

    def pick(scene, lights, cfg, renderer="auto"):
        """Whether the path-traced route is the kernel's."""
        return routes.pick(scene, cfg, renderer, pathtrace=True,
                           lights=lights).name == "pathtrace kernel"

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
