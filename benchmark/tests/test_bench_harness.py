"""The harness rehearsed on the CPU at a tiny size, with the kernels' plain
versions: the cells and their files by name, the window, the sink and
the recorder, the metric readers on a recorded span, the last line's
shape, the faults the check must catch, and the control."""

import json
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import cells, control, harness, window
from benchmark.trace import Record, Span, breakdown

CELLS = ["demo.orbit", "many10k.orbit", "demo.batch8"]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_cell_config_and_metric_is_found_by_name():
    spec = cells.load_spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    for c in spec["configs"]:
        assert NAME.match(c["name"]) and (cells.ROOT / c["file"]).is_file()
    for w in spec["workloads"]:
        cell = cells.load_cell(w["name"], spec)
        assert cell["config"]["name"] == w["config"]
        assert cell["workload"]["name"] == w["name"]
        assert (cells.HERE / "scenes" / f"{cell['config']['kind']}.py"
                ).is_file()
        # the batched cell's write intervals are read per layer
        assert {m["name"] for m in cell["end_to_end"]} == {
            "fps", "latency_ms_p95", "setup_s"} | (
            set() if w["name"] == "demo.batch8" else {"frame_ms_p95"}) | (
            {"frame_ms_mean"} if w["name"] == "many10k.orbit" else set())
        assert cell["per_layer"]
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"])
    # a per-layer metric moves an end-to-end metric that every cell it is
    # read in reports
    everywhere = [w["name"] for w in spec["workloads"]]
    for m in spec["per_layer"]:
        assert (cells.HERE / "metrics" / f"{m['name']}.py").is_file()
        for w in m.get("workloads", everywhere):
            assert m["moves"] in {e["name"] for e in cells.load_cell(
                w, spec)["end_to_end"]}, (m["name"], w)
    with pytest.raises(cells.UnknownCell):
        cells.load_cell("no.such.cell", spec)


@pytest.mark.parametrize("cell", CELLS)
def test_a_cell_runs_on_the_cpu_and_prints_the_line(cell, tiny):
    run = harness.run_cell(cell, 2**31 + 5, 1.0, False, device="cpu",
                           overrides=tiny)
    line = json.loads(json.dumps(run.line))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "check"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] == run.sink.frames >= 2
    assert set(line["metrics"]) == {m["name"]
                                    for m in run.cell["end_to_end"]}
    assert "fps" in line["metrics"] and "setup_s" in line["metrics"]
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert line["device"]["platform"] == "cpu"
    assert set(line["check"]) == {"mean_abs_diff", "far_px_pct",
                                  "bad_frames", "frames_checked"}
    assert harness.check_lines(run.checked)[0].startswith(
        "check mean_abs_diff ")
    # every frame written was one whole frame, and frame 0 and the last
    # were among those checked
    assert not run.sink.bad_frames
    checked = [f["frame"] for f in run.compared]
    assert checked[0] == 0 and checked[-1] == run.sink.frames - 1


def test_the_recorder_gives_each_frame_its_scene_time(tiny):
    run = harness.run_cell("demo.batch8", 11, 0.5, False, device="cpu",
                           overrides=tiny)
    frames = [f["frame"] for f in run.compared]
    ts = {f["frame"]: f["t"] for f in run.compared}
    phase = float(harness.seed_stream(11, 1).uniform(0.0, 100.0))
    for i in frames:
        want = np.float32(np.float32(phase + (i // 8) * 8 / 60.0)
                          + np.float32(i % 8) * np.float32(1 / 60.0))
        assert ts[i] == pytest.approx(float(want), abs=1e-5)


def test_the_sink_assembles_chunked_frames_and_flags_bad_ones():
    sink = window.Sink(10, keep_after=[(0.0, 1)])
    clock = window.FrameClock(sink)
    for chunks in ([b"01234", b"56789"], [b"0123456789"], [b"012"]):
        with clock.stage("encode+write"):
            for c in chunks:
                sink.write(c)
        sink.write(b"fps line")
    assert sink.frames == 3 and sink.bad_frames == [2]
    assert b"".join(sink.kept[0]) == b"0123456789"
    assert list(sink.kept) == [0, 2]
    assert len(clock.written) == 3


def _span():
    """Two frames over 10 ms: a 2 ms kernel, a 1 ms copy, 7 ms idle."""
    dev = [("render_kernel<false>", 1000.0, 3000.0),
           ("Memcpy DtoH", 3000.0, 4000.0),
           ("render_kernel<false>", 6000.0, 6500.0),
           ("Memcpy DtoH", 6500.0, 7000.0)]
    host = [("stage:render+copy", 0.0, 4200.0),
            ("stage:encode+write", 4200.0, 5000.0),
            ("stage:render+copy", 5000.0, 7200.0),
            ("stage:encode+write", 7200.0, 10000.0),
            ("cudaStreamSynchronize", 3990.0, 4100.0)]
    return Span(0.0, 10000.0, 2, 5, dev, host)


def test_the_metric_readers_read_a_recorded_span(tiny):
    cell = cells.load_cell("demo.orbit", overrides=tiny)
    rec = Record(cell, 4, {"encode+write": [0.001] * 4,
                           "render+copy": [0.003] * 4}, _span(),
                 lambda: [1000, 1000])
    read = {m["name"]: harness._metric_reader(m["name"])(rec)
            for m in cells.load_spec()["per_layer"]}
    assert read["encode_write_ms"] == pytest.approx(1.0)
    assert read["render_copy_ms"] == pytest.approx(3.0)
    assert read["kernels_per_frame"] == 1.0
    assert read["device_idle_pct"] == pytest.approx(60.0)
    assert read["render_kernel_roofline"] == pytest.approx(
        100 * (1e3 * 1000 * 128 / 67e12) / 1.25)
    assert read["mesh_fused_kernel_ms"] is None
    assert read["frame_ms_p95.batched"] is None
    rec.end_to_end = {"fps": 400.0, "frame_ms_p95": 3.25}
    assert harness._metric_reader("frame_ms_p95.batched")(rec) == 3.25
    bd = breakdown(_span())
    assert bd["device_ops"][0] == ["render_kernel<false>", 0.0025]
    assert bd["idle_gaps"][0][0] == "encode+write/host code"
    assert sum(v for _, v in bd["idle_gaps"]) == pytest.approx(0.006)
    # nothing to read: no span, the metric left out
    rec = Record(cell, 4, {}, None, list)
    assert harness._metric_reader("device_idle_pct")(rec) is None
    assert harness._metric_reader("encode_write_ms")(rec) is None


@pytest.mark.parametrize("cell", ["demo.orbit", "demo.batch8",
                                  "physics.drop"])
def test_a_traced_cpu_run_leaves_device_metrics_out(cell, tiny):
    """On the CPU a traced run reports exactly the metrics whose readers
    read the host: the program's spans and set-up phases, and the host
    clock's (the batched cell's write intervals); no device trace, and no
    count of steps on the card."""
    if cell == "physics.drop":
        tiny = {**tiny, "config": {**tiny["config"], "width": 48,
                                   "height": 16}}
    run = harness.run_cell(cell, 3, 1.0, True, device="cpu", overrides=tiny)
    spans = {m["name"] for m in run.cell["per_layer"]
             if m["source"] in ("program_span", "host_clock")}
    assert set(run.line["metrics"]) == spans
    assert ("physics_ms" in spans) == (cell == "physics.drop")
    assert ("frame_ms_p95.batched" in spans) == (cell == "demo.batch8")
    assert "busy_s" not in run.line["device"]


def _stale(app):
    """Each step returns the first frame it made."""
    real = app.build_frame_step

    def build(*a, **k):
        step, first = real(*a, **k), []

        def frame_step(t, off):
            if not first:
                first.append(step(t, off))
            return first[0]

        return frame_step

    return "build_frame_step", build


def _altered(app):
    """Each frame's red channel inverted where the step makes it."""
    real = app.build_frame_step

    def build(*a, **k):
        step = real(*a, **k)

        def frame_step(t, off):
            out = step(t, off).clone()
            out[..., 0] = 255 - out[..., 0]
            return out

        return frame_step

    return "build_frame_step", build


def _half_batch(app):
    """The batch's second half left out: black frames."""
    real = app.build_frame_batch_step

    def build(*a, **k):
        step = real(*a, **k)

        def batch_step(t0, off):
            out = step(t0, off).clone()
            out[out.shape[0] // 2:] = 0
            return out

        return batch_step

    return "build_frame_batch_step", build


@pytest.mark.parametrize("cell,fault", [("demo.orbit", _stale),
                                        ("many10k.orbit", _stale),
                                        ("demo.orbit", _altered),
                                        ("demo.batch8", _half_batch)])
def test_a_broken_timed_path_is_not_correct(cell, fault, tiny, monkeypatch):
    from ttrt_torch import app

    monkeypatch.setattr(app, *fault(app))
    run = harness.run_cell(cell, 21, 1.5, False, device="cpu",
                           overrides=tiny)
    assert run.line["correct"] is False and run.line["failed"] >= 1


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_in_the_program_place_is_not_correct(cell, tiny):
    """The reference in bfloat16 made where the program makes its frames,
    then copied, encoded, written and judged by the run's own check."""
    from ttrt_torch import app

    seed = 2**31 + 8
    with control.Planted(app, cells.load_cell(cell, overrides=tiny), seed,
                         "cpu"):
        run = harness.run_cell(cell, seed, 0.5, False, device="cpu",
                               overrides=tiny)
    assert app.build_frame_step.__module__ == "ttrt_torch.app"
    assert run.line["correct"] is False and run.line["failed"] >= 1
    assert any(run.line["check"][n]["value"] > run.line["check"][n]["limit"]
               for n in harness.LIMITED), run.line["check"]
    assert not run.sink.bad_frames


@pytest.mark.parametrize("cell", ["demo.orbit", "demo.batch8"])
def test_the_reference_itself_in_the_program_place_is_correct(cell, tiny):
    """The float32 reference planted as the control is: every frame the
    check decodes is judged at the scene time it was made for, so it
    reads no difference at all."""
    from ttrt_torch import app

    seed = 2**31 + 9
    with control.Planted(app, cells.load_cell(cell, overrides=tiny), seed,
                         "cpu", torch.float32):
        run = harness.run_cell(cell, seed, 0.5, False, device="cpu",
                               overrides=tiny)
    assert run.line["correct"] is True
    assert all(f["diff_px_pct"] == 0.0 for f in run.compared)


def test_kernel_time_a_frame_counts_every_launch(tiny):
    """A kernel split into two launches a frame reads its frame's whole
    time, and its roofline share the summed bound over the summed time."""
    dev = [("render_kernel<false>", 0.0, 1000.0),
           ("render_kernel<false>", 1000.0, 1500.0),
           ("render_kernel<false>", 5000.0, 6000.0),
           ("render_kernel<false>", 6000.0, 6500.0),
           ("mesh_fused_kernel<1>", 1500.0, 2500.0),
           ("mesh_fused_kernel<1>", 6500.0, 8500.0)]
    host = [("stage:encode+write", 0.0, 10000.0)]
    span = Span(0.0, 10000.0, 2, 0, dev, host)
    assert span.kernel_ms("render_kernel") == pytest.approx(1.5)
    cell = cells.load_cell("demo.orbit", overrides=tiny)
    rec = Record(cell, 2, {}, span, lambda: [1000, 3000])
    read = harness._metric_reader
    assert read("mesh_fused_kernel_ms")(rec) == pytest.approx(1.5)
    assert read("render_kernel_roofline")(rec) == pytest.approx(
        100 * (1e3 * 2000 * 128 / 67e12) / 1.5)


def test_the_reference_finds_its_scene_and_sky_by_name(tiny):
    from benchmark.reference import demo, many, sky_colors

    for cell, kind in [("demo.orbit", demo), ("many10k.orbit", many)]:
        scene, sky, render = harness.reference(
            cells.load_cell(cell, overrides=tiny), "cpu")
        assert type(scene).__module__ == kind.__name__
        assert isinstance(sky, sky_colors.ColorsSky)
    bad = cells.load_cell("demo.orbit", overrides={"config": {
        "sky": "no_such_sky"}})
    with pytest.raises(ModuleNotFoundError, match="sky_no_such_sky"):
        harness.reference(bad, "cpu")


def test_the_command_without_a_card_prints_no_result(tmp_path):
    assert not torch.cuda.is_available()
    args = ["--workload", "demo.orbit", "--seed", "1", "--seconds", "1"]
    r = subprocess.run([sys.executable, "-m", "benchmark.run", *args],
                       cwd=cells.ROOT, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 3 and r.stdout == ""
    # a checkout of the benchmark alone
    shutil.copy(cells.SPEC, tmp_path / "BENCHMARK.json")
    shutil.copytree(cells.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run([sys.executable, "-m", "benchmark.run", *args],
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode != 0 and r.stdout == ""
