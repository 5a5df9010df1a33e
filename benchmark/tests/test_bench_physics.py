"""The physics cell, physics.drop, on the CPU at a small size: the frozen
world step against the program's bit for bit, a run through
``run_physics`` that is correct, its recorded times and states, the
faults its check must catch, the control, the ``physics_ms`` reader,
and the breakdown of a span of many launches."""

import pytest
import torch

from benchmark import cells, control, harness
from benchmark.reference import physics, raytrace
from benchmark.tests.conftest import TINY
from benchmark.trace import Record, Span, breakdown

CELL = "physics.drop"
# TINY's samples and bounces; 48 x 16 pixels, every row: the render
# kernel's plain version and the eager reference differ on a few pixels a
# frame (a sample on a checker edge), which at 24 x 8 and three rows can
# be more than the limit's share
SMALL = {"config": {**TINY["config"], "width": 48, "height": 16},
         "workload": {**TINY["workload"], "check": {"rows": None}}}


def _leaves(s):
    return [*s.pos, *s.vel, s.t]


def test_the_frozen_step_equals_the_program_bit_for_bit():
    """360 frames (6 s) of the drop, state by state, in float32: the
    spheres bounce on the ground and off the walls, and from about frame
    260 the one dropped from y = 4.5 rests on the one below it, so every
    branch of the step runs."""
    from ttrt_torch import assets
    from ttrt_torch.physics import demo, world
    from ttrt_torch.scene import demo_scene

    scene = demo_scene(assets.load_skybox("colors", device="cpu"), 8, 4,
                       dtype=torch.float32, device="cpu")
    state, params = demo.build_physics_demo(scene)
    dt = torch.tensor(1.0 / 60.0, dtype=torch.float32)
    drop = physics.build(cells.load_cell(CELL)["config"],
                         dtype=torch.float32, device="cpu")
    assert drop.state_gap(state) == (True, 0.0)
    touched = grounded = 0
    for k in range(1, 361):
        state = world.physics_step(state, params, dt, demo.SUBSTEPS)
        ref = drop.at(k)
        assert all(torch.equal(a, b) for a, b in zip(_leaves(ref),
                                                     _leaves(state))), k
        p = torch.stack(list(ref.pos), dim=1)
        gap = torch.cdist(p, p) + 2.0 * torch.eye(6)
        touched += bool((gap < 1.0 + 1e-4).any())
        grounded += bool((ref.pos.y <= -1.5 + 1e-6).any())
    assert touched > 60 and grounded > 60, (touched, grounded)
    # asked for an earlier frame, the drop starts again from t = 0
    fresh = physics.build(cells.load_cell(CELL)["config"],
                          dtype=torch.float32, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(_leaves(drop.at(3)),
                                                 _leaves(fresh.at(3))))


def test_a_physics_run_is_correct_and_follows_the_world():
    run = harness.run_cell(CELL, 2**31 + 5, 1.0, False, device="cpu",
                           overrides=SMALL)
    line = run.line
    assert line["correct"] is True and line["failed"] == 0, line["check"]
    assert set(line["metrics"]) == {"fps", "frame_ms_p95",
                                    "latency_ms_p95", "setup_s"}
    assert line["attempted"] == run.sink.frames >= 2
    checked = [f["frame"] for f in run.compared]
    assert checked[0] == 0 and checked[-1] == run.sink.frames - 1
    # frame i shows the world after i + 1 steps of 1/60 s, and its state
    # is the reference's, bit for bit
    assert [f["t"] for f in run.compared] == [(i + 1) / 60.0
                                              for i in checked]
    assert [g[0] for g in run.state_gaps] == checked
    assert all(same and gap == 0.0 for _, same, gap in run.state_gaps)
    last = run.states[run.sink.frames - 1]
    assert float(last.t) == pytest.approx(run.sink.frames / 60.0, rel=1e-5)


def _first_frame(app):
    """Each step returns the first frame it made (the world goes on)."""
    real = app.build_physics_frame_step

    def build(*a, **k):
        step, first = real(*a, **k), []

        def frame_step(state, off, count_rays=False):
            new, fb, rays = step(state, off, count_rays)
            first.append(fb)
            return new, first[0], rays

        return frame_step

    return build


def _stuck(app):
    """Each step returns the state it was given: the world never moves."""
    real = app.build_physics_frame_step

    def build(*a, **k):
        step = real(*a, **k)

        def frame_step(state, off, count_rays=False):
            _, fb, rays = step(state, off, count_rays)
            return state, fb, rays

        return frame_step

    return build


def _altered(app):
    """Each frame's red channel inverted where the step makes it."""
    real = app.build_physics_frame_step

    def build(*a, **k):
        step = real(*a, **k)

        def frame_step(state, off, count_rays=False):
            new, fb, rays = step(state, off, count_rays)
            return new, fb._replace(x=1.0 - fb.x), rays

        return frame_step

    return build


@pytest.mark.parametrize("fault", [_first_frame, _stuck, _altered])
def test_a_stale_physics_step_is_not_correct(fault, monkeypatch):
    from ttrt_torch import app

    monkeypatch.setattr(app, "build_physics_frame_step", fault(app))
    run = harness.run_cell(CELL, 31, 1.5, False, device="cpu",
                           overrides=SMALL)
    assert run.line["correct"] is False and run.line["failed"] >= 1
    assert any(run.line["check"][n]["value"] > run.line["check"][n]["limit"]
               for n in harness.LIMITED), run.line["check"]


@pytest.mark.parametrize("dtype,correct", [(control.DTYPE, False),
                                           (torch.float32, True)])
def test_the_reference_planted_in_the_physics_loop(dtype, correct):
    """The bfloat16 reference (its world stepped in bfloat16 too) in the
    physics step's place fails the check; the float32 reference there
    reads no difference at all."""
    from ttrt_torch import app

    seed = 2**31 + 8
    cell = cells.load_cell(CELL, overrides=SMALL)
    with control.Planted(app, cell, seed, "cpu", dtype):
        run = harness.run_cell(CELL, seed, 1.0, False, device="cpu",
                               overrides=SMALL)
    assert app.build_physics_frame_step.__module__ == "ttrt_torch.physics.demo"
    assert not run.sink.bad_frames
    assert run.line["correct"] is correct, run.line["check"]
    if correct:
        assert all(f["diff_px_pct"] == 0.0 for f in run.compared)
    else:
        assert any(run.line["check"][n]["value"]
                   > run.line["check"][n]["limit"] for n in harness.LIMITED)


def test_the_reference_finds_the_physics_kind_and_its_render():
    scene, _, render = harness.reference(cells.load_cell(CELL), "cpu")
    assert isinstance(scene, physics.Drop) and render is physics.render
    _, _, render = harness.reference(cells.load_cell("demo.orbit"), "cpu")
    assert render is raytrace.render


def test_physics_ms_reads_the_physics_stage():
    spec = {m["name"]: m for m in cells.load_spec()["per_layer"]}
    m = spec["physics_ms"]
    assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"],
            m["workloads"]) == ("ms", "lower", "program_span",
                                "physics step", "fps", [CELL])
    cell = cells.load_cell(CELL, overrides=SMALL)
    read = harness._metric_reader("physics_ms")
    rec = Record(cell, 4, {"physics": [0.05, 0.04, 0.06, 0.05],
                           "render+copy": [0.06] * 4}, None, list)
    assert read(rec) == pytest.approx(50.0)
    assert read(Record(cell, 4, {"render+copy": [0.06] * 4}, None,
                       list)) is None


def test_the_breakdown_of_a_span_of_many_launches():
    """A physics frame's span holds thousands of launches and as many idle
    gaps: each gap is labelled by the host events around its middle as a
    scan of every event would label it, in one sweep."""
    import random

    rng = random.Random(7)
    dev, host, t = [], [("stage:render+copy", 0.0, 40000.0),
                        ("stage:physics", 10.0, 39000.0)], 0.0
    for i in range(3000):
        t += rng.uniform(2.0, 20.0)
        dev.append(("add_kernel" if i % 3 else "where_kernel", t, t + 3.0))
        host.append((rng.choice(["aten::add", "cudaLaunchKernel"]),
                     t - rng.uniform(0.0, 8.0), t + rng.uniform(0.0, 8.0)))
    span = Span(0.0, 40000.0, 5, 20, dev, host)
    idle = {}
    gaps, end = [], span.start_us
    for s, e in span.busy() + [(span.end_us, span.end_us)]:
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        around = [h for h in host if h[1] <= mid <= h[2]]
        stage = [h[0][6:] for h in around if h[0].startswith("stage:")]
        ops = sorted((h for h in around if not h[0].startswith("stage:")),
                     key=lambda h: h[2] - h[1])
        label = (f"{stage[0] if stage else 'between stages'}/"
                 f"{ops[0][0][:80] if ops else 'host code'}")
        idle[label] = idle.get(label, 0.0) + (g1 - g0) * 1e-6
    want = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    got = breakdown(span)["idle_gaps"]
    assert [k for k, _ in got] == [k for k, _ in want]
    assert [v for _, v in got] == pytest.approx([v for _, v in want])
