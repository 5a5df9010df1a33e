"""The port's spans on the CPU: every loop path opens each frame span once a
frame (once a batch for the batch's copy), nested in its loop stage or, for
the pipelined and batched steps, between the stages on the issuing thread;
``span`` outside a loop is one shared no-op; ``StageTimers`` marks the
profiler only while it runs; ``SETUP`` tiles a process's start up to its
first frame's write."""

import contextlib
import io
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

from ttrt_torch import app
from ttrt_torch.config import RenderConfig
from ttrt_torch.utils import profiling

torch.set_num_threads(1)  # the test workers share the cores

REPO = Path(__file__).resolve().parent.parent
STEP = ("pose", "pack", "launch", "quantize", "device_wait", "copy")
WRITE = ("encode", "write")
FRAMES = 4


class Intervals:
    """Timers that keep each stage's (name, start, end, thread)."""

    def __init__(self):
        self.rows = []

    @contextlib.contextmanager
    def stage(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.rows.append((name, t0, time.perf_counter(),
                              threading.get_ident()))

    def of(self, name):
        return [r for r in self.rows if r[0] == name]

    def total(self, name):
        return sum(e - s for _, s, e, _ in self.of(name))


def _inside(row, outer):
    return any(o[1] <= row[1] and row[2] <= o[2] and o[3] == row[3]
               for o in outer)


def _run(timers, **kw):
    cfg = RenderConfig(width=12, height=6, rays_per_pixel=2, bounce_limit=3,
                       frame_rate=1e9)
    app.run_animation(cfg, "colors", max_frames=FRAMES, interactive=False,
                      encode="host", device="cpu", stream=io.BytesIO(),
                      timers=timers, **kw)


@pytest.mark.parametrize("kw", [{}, {"pathtrace": True},
                                {"mesh_spec": "auto"}],
                         ids=["single", "pathtrace", "mesh"])
def test_each_frame_span_opens_once_a_frame_inside_its_stage(kw):
    t = Intervals()
    _run(t, **kw)
    steps, writes = t.of("render+copy"), t.of("encode+write")
    assert len(steps) == len(writes) == FRAMES
    for name in STEP + WRITE:
        rows = t.of(name)
        assert len(rows) == FRAMES, name
        outer = steps if name in STEP else writes
        assert all(_inside(r, outer) for r in rows), name
    assert sum(t.total(n) for n in STEP) <= t.total("render+copy")
    assert sum(t.total(n) for n in WRITE) <= t.total("encode+write")


def test_the_pipelined_step_spans_run_between_stages_and_copy_in_the_pool():
    t = Intervals()
    _run(t, pipeline=2)
    main = threading.get_ident()
    stages = t.of("render+copy") + t.of("encode+write") + t.of("pace")
    for name in STEP:
        rows = t.of(name)
        assert len(rows) == FRAMES, name
        on_main = name not in ("device_wait", "copy")
        assert all((r[3] == main) == on_main for r in rows), name
        if on_main:
            assert not any(_inside(r, stages) for r in rows), name
    for name in WRITE:
        assert len(t.of(name)) == FRAMES
        assert all(_inside(r, t.of("encode+write")) for r in t.of(name))


def test_the_batch_step_spans_each_frame_and_copies_once_a_batch():
    batch = 3
    t = Intervals()
    _run(t, batch=batch)
    main = threading.get_ident()
    stages = t.of("render+copy") + t.of("encode+write") + t.of("pace")
    copies = t.of("copy")
    assert len(t.of("device_wait")) == len(copies) >= 2
    assert all(r[3] != main for r in copies + t.of("device_wait"))
    for name in ("pose", "pack", "launch", "quantize"):
        rows = t.of(name)
        assert len(rows) == batch * len(copies), name
        assert all(r[3] == main and not _inside(r, stages) for r in rows)
    for name in WRITE:
        assert len(t.of(name)) == FRAMES
        assert all(_inside(r, t.of("encode+write")) for r in t.of(name))


def test_spans_record_into_stage_timers_and_stats_logs_the_mean_fps(capsys):
    timers = profiling.StageTimers()
    _run(timers, stats=True)
    summary = timers.summary()
    for name in STEP + WRITE + ("render+copy", "encode+write", "pace"):
        assert summary[name]["n"] == FRAMES, name
    err = capsys.readouterr().err
    assert f"frames: {FRAMES}  mean " in err and " fps" in err
    assert "ema:" not in err


def test_span_outside_a_loop_is_one_shared_no_op():
    assert profiling._recorder is None
    spans = {id(profiling.span(n)) for n in STEP + WRITE + ("other",)}
    assert spans == {id(profiling.NO_SPAN)}
    outer, inner = Intervals(), Intervals()
    with profiling.span("pose"):
        pass
    with profiling.recording(outer):
        with profiling.recording(inner):
            with profiling.span("pose"):
                pass
        with profiling.span("copy"):
            pass
    with profiling.span("write"):
        pass
    assert [r[0] for r in inner.rows] == ["pose"]
    assert [r[0] for r in outer.rows] == ["copy"]
    assert profiling._recorder is None
    _run(Intervals())
    assert profiling._recorder is None
    assert profiling.span("pose") is profiling.NO_SPAN


def test_stage_timers_mark_the_profiler_only_while_it_runs(monkeypatch):
    timers = profiling.StageTimers()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with timers.stage("pose"):
            torch.ones(4).add_(1)
    assert "pose" in {e.name for e in prof.events()}

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with timers.stage("pose"):
        pass
    assert timers.summary()["pose"]["n"] == 2


def _python(code):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    return r.stdout


def test_setup_phases_tile_the_start_up_to_the_first_write():
    out = json.loads(_python(
        "import io, json\n"
        "from ttrt_torch import app\n"
        "from ttrt_torch.config import RenderConfig\n"
        "from ttrt_torch.utils.profiling import SETUP\n"
        "cfg = RenderConfig(width=8, height=4, rays_per_pixel=1, "
        "bounce_limit=2, frame_rate=1e9)\n"
        "for _ in range(2):\n"
        "    app.run_animation(cfg, 'colors', max_frames=2, "
        "interactive=False, device='cpu', stream=io.BytesIO())\n"
        "print(json.dumps({'spans': SETUP.spans, "
        "'phases': SETUP.phases()}))\n").splitlines()[-1])
    spans, phases = out["spans"], out["phases"]
    assert list(spans) == list(profiling.PHASES)
    assert set(phases) == set(profiling.PHASES) | {"other"}
    ordered = [spans[n] for n in profiling.PHASES]
    for (s0, e0), (s1, e1) in zip(ordered, ordered[1:]):
        assert s0 <= e0 <= s1 <= e1
    total = spans["first_frame"][1] - spans["before_program"][0]
    for name in profiling.PHASES:
        assert 0 <= phases[name] <= total, name
        assert phases[name] == pytest.approx(
            spans[name][1] - spans[name][0])
    assert phases["other"] >= 0
    assert phases["other"] == pytest.approx(
        total - sum(phases[n] for n in profiling.PHASES), abs=1e-9)


def test_the_package_import_loads_no_module_of_its_own_beyond_itself():
    new = json.loads(_python(
        "import json, sys\n"
        "before = set(sys.modules)\n"
        "import ttrt_torch\n"
        "print(json.dumps(sorted(set(sys.modules) - before)))\n"))
    assert new == ["ttrt_torch"]
