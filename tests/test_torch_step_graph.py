"""The frame steps replayed as CUDA graphs (``ttrt_torch.step_graph``).

On the CPU: the rule that decides which steps are graphed, and the count
of eager steps. On the card (marked ``cuda``; each test skips without a
CUDA device): replayed steps against the same steps run eagerly, bit for
bit (the demo under both encodes, the batch of 8, the fused kernel's
many-sphere scene, three batches in flight), and the counters. The
machine with the card has no JAX, so run these without the repository's
conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_step_graph.py
"""

import io
from types import SimpleNamespace

import pytest
import torch

from ttrt_torch import app, routes, step_graph
from ttrt_torch.config import RenderConfig
from ttrt_torch.kernels import mesh_fused, render
from ttrt_torch.utils import profiling

torch.set_num_threads(1)  # the test workers share the cores

SMALL = RenderConfig(width=12, height=6, rays_per_pixel=2, bounce_limit=3,
                     frame_rate=1e9)
FULL = RenderConfig()  # the demo's 480x280, 10 samples, 10 bounces
TIMES = (0.0, 0.37, 1.5, 2.25, 7.9, 63.125)


def test_the_rule_graphs_a_cuda_kernel_step_without_mesh_or_nan_check():
    scenes = {kind: app.make_scene(kind, SMALL, "colors", device="cpu",
                                   n_spheres=50) for kind in ("demo", "many")}
    mesh = SimpleNamespace(mesh_dim_names=("rows", "samples"),
                           mesh=torch.zeros(2, 1), size=lambda: 2)
    for scene, fn in ((scenes["demo"], render.render_frame),
                      (scenes["many"], mesh_fused.render_frame_mesh_fused)):
        route = routes.pick(scene, SMALL)
        assert route.fn is fn
        assert step_graph.engages("cuda", route)
        assert step_graph.engages(torch.device("cuda", 0), route)
        assert not step_graph.engages("cpu", route)
        assert not step_graph.engages("cuda", route, debug_nans=True)
        assert not step_graph.engages("cuda",
                                      routes.pick(scene, SMALL, mesh=mesh))
    for scene in scenes.values():
        for route in (routes.pick(scene, SMALL, "eager"),
                      routes.pick(scene, SMALL, pathtrace=True)):
            assert not step_graph.engages("cuda", route)


def test_no_step_on_the_cpu_is_graphed_or_counted(monkeypatch):
    scene = app.make_scene("demo", SMALL, "colors", device="cpu")
    steps = [app.build_frame_step(scene, SMALL, "host"),
             app.build_frame_step(scene, SMALL, "device"),
             app.build_frame_batch_step(scene, SMALL, 3),
             app.build_pathtrace_frame_step(scene, SMALL, "host")]
    assert not any(isinstance(s, step_graph.GraphedStep) for s in steps)
    for kw in ({}, {"batch": 3}, {"pathtrace": True}):
        app.run_animation(SMALL, "colors", max_frames=3, interactive=False,
                          device="cpu", stream=io.BytesIO(), **kw)
        assert (profiling.STEPS.replayed, profiling.STEPS.eager) == (0, 0)
    # the rule without its device: build_frame_step and
    # build_frame_batch_step graph a kernel's route, and the path tracer's
    # route is never graphable: its frame seed is a host value of each frame
    monkeypatch.setattr(step_graph, "engages",
                        lambda device, route, *a, **kw: route.graphable)
    assert isinstance(app.build_frame_step(scene, SMALL, "host"),
                      step_graph.GraphedStep)
    assert isinstance(app.build_frame_batch_step(scene, SMALL, 3),
                      step_graph.GraphedStep)
    assert not isinstance(app.build_pathtrace_frame_step(scene, SMALL),
                          step_graph.GraphedStep)


def test_eager_steps_count_on_a_cuda_device_and_each_loop_starts_anew():
    def step(t, cam_offset):
        return t

    assert step_graph.eager(step, "cpu") is step
    counted = step_graph.eager(step, "cuda")
    with profiling.recording(profiling.StageTimers()):
        assert [counted(t, None) for t in (1, 2, 3)] == [1, 2, 3]
    assert (profiling.STEPS.replayed, profiling.STEPS.eager) == (0, 3)
    with profiling.recording(profiling.StageTimers()):
        assert profiling.STEPS.eager == 0


# -- on the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _offsets(device):
    return (torch.zeros(3, device=device),
            torch.tensor([0.3, -0.2, 0.15], device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("encode", ["host", "device"])
def test_a_replayed_demo_step_equals_the_eager_step(cuda, encode):
    scene = app.make_scene("demo", FULL, "colors", device=cuda)
    step = app.build_frame_step(scene, FULL, encode)
    assert isinstance(step, step_graph.GraphedStep)
    zero, moved = _offsets(cuda)
    for i, t in enumerate(TIMES):
        off = moved if i in (3, 4) else zero  # changed between replays
        got = step(t, off)
        want = step.body(t, off)
        assert got.dtype == torch.uint8
        assert torch.equal(got, want), (encode, t, i)
    assert step.graph is not None


def _batch_times(t0, batch, cfg):
    return (torch.tensor(t0, dtype=torch.float32)
            + torch.arange(batch, dtype=torch.float32)
            * torch.tensor(cfg.frame_duration)).tolist()


@pytest.mark.cuda
def test_a_replayed_batch_of_8_equals_8_eager_single_steps(cuda):
    scene = app.make_scene("demo", FULL, "colors", device=cuda)
    batch = app.build_frame_batch_step(scene, FULL, 8)
    single = app.build_frame_step(scene, FULL, "host")
    _, moved = _offsets(cuda)
    for t0 in (1.5, 20.75, 3.0):  # the first call, then two replays
        frames = batch(t0, moved)
        for k, t in enumerate(_batch_times(t0, 8, FULL)):
            assert torch.equal(frames[k], single.body(t, moved)), (t0, k)
    assert batch.graph is not None


@pytest.mark.cuda
def test_a_many_sphere_step_replays_the_fused_kernel_bit_for_bit(cuda):
    cfg = RenderConfig(width=160, height=96, rays_per_pixel=4,
                       bounce_limit=6)
    scene = app.make_scene("many", cfg, "colors", device=cuda,
                           n_spheres=500)
    step = app.build_frame_step(scene, cfg, "host")
    assert isinstance(step, step_graph.GraphedStep)
    zero, moved = _offsets(cuda)
    for i, t in enumerate(TIMES[:4]):
        off = moved if i == 2 else zero
        assert torch.equal(step(t, off), step.body(t, off)), (t, i)
    assert dict(step.launches) == {mesh_fused.render_band_mesh_fused_cuda: 1}


@pytest.mark.cuda
def test_three_batches_in_flight_each_equal_their_eager_frames(cuda):
    """Past the batched loop's depth of 3: four steps (the eager first
    call, then three replays) issued before any copy; a replay's result
    is not the buffer the next replay writes."""
    scene = app.make_scene("demo", FULL, "colors", device=cuda)
    batch = app.build_frame_batch_step(scene, FULL, 8)
    single = app.build_frame_step(scene, FULL, "host")
    zero, _ = _offsets(cuda)
    t0s = (0.0, 8 / 60, 16 / 60, 24 / 60)
    in_flight = [batch(t0, zero) for t0 in t0s]  # eager, then 3 replays
    for t0, frames in zip(t0s, in_flight):
        frames = frames.cpu()
        for k, t in enumerate(_batch_times(t0, 8, FULL)):
            assert torch.equal(frames[k], single.body(t, zero).cpu()), (t0,
                                                                        k)


@pytest.mark.cuda
def test_the_counters_count_what_ran(cuda):
    cfg = SMALL.with_(width=96, height=56)
    many = app.make_scene("many", cfg, "colors", device=cuda, n_spheres=300)
    cases = [  # (loop arguments, replayed, eager, wrapper, its launches)
        ({"max_frames": 5}, 4, 1, render.render_frame_cuda, 5),
        ({"max_frames": 5, "encode": "device", "pipeline": 2}, 4, 1,
         render.render_frame_cuda, 5),
        # the batched loop issues while issued < frames + batch
        ({"max_frames": 16, "batch": 8}, 2, 1, render.render_frame_cuda,
         24),
        ({"max_frames": 3, "scene": many}, 2, 1,
         mesh_fused.render_band_mesh_fused_cuda, 3),
        ({"max_frames": 2, "debug_nans": True}, 0, 2,
         render.render_frame_cuda, 2),
        ({"max_frames": 2, "renderer": "eager"}, 0, 2,
         render.render_frame_cuda, 0),
    ]
    for kw, replayed, eager, wrapper, launches in cases:
        before = wrapper.launches
        kw.setdefault("encode", "host")
        app.run_animation(cfg, "colors", interactive=False, device=cuda,
                          stream=io.BytesIO(), **kw)
        torch.cuda.synchronize()
        got = (profiling.STEPS.replayed, profiling.STEPS.eager,
               wrapper.launches - before)
        assert got == (replayed, eager, launches), kw
