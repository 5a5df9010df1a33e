"""The readers of the program's spans: the eight frame spans and the six
set-up phases on a recorded ``Record``, ``idle_unspanned_pct`` on a
hand-made span with known gaps, each silent where the program has no such
span or record, and a traced CPU run that reports every program span and
no device metric."""

import pytest

from benchmark import cells, harness
from benchmark.trace import Record, Span

FRAME = ["pose", "pack", "launch", "quantize", "device_wait", "copy",
         "encode", "write"]
SETUP = ["before_program", "import", "device", "scene", "first_frame",
         "other"]
NEW = ([f"{n}_ms" for n in FRAME] + [f"setup_{n}_s" for n in SETUP]
       + ["idle_unspanned_pct"])
CELLS = ["demo.orbit", "many10k.orbit", "demo.batch8"]


def test_the_new_metrics_are_declared_for_every_cell():
    spec = {m["name"]: m for m in cells.load_spec()["per_layer"]}
    for name in NEW:
        m = spec[name]
        # the physics step opens no 'pose' span (its camera follows the
        # state), so physics.drop does not report pose_ms
        assert m["workloads"] == CELLS + (
            [] if name == "pose_ms" else ["physics.drop"]), name
        assert (cells.HERE / "metrics" / f"{name}.py").is_file()
        assert m["moves"] == ("setup_s" if name.startswith("setup_")
                              else "fps"), name
    layers = {spec[n]["layer"] for n in NEW}
    assert layers == {"frame step and copy", "loop and terminal write",
                      "set-up", "device"}


def test_the_frame_span_readers_read_ms_a_frame(tiny):
    cell = cells.load_cell("demo.orbit", overrides=tiny)
    stages = {n: [0.001 * (i + 1)] * 4 for i, n in enumerate(FRAME)}
    rec = Record(cell, 4, stages, None, list)
    for i, n in enumerate(FRAME):
        assert harness._metric_reader(f"{n}_ms")(rec) == pytest.approx(
            i + 1.0), n
    # the parent's program opens none of them
    bare = Record(cell, 4, {"render+copy": [0.003] * 4}, None, list)
    assert all(harness._metric_reader(f"{n}_ms")(bare) is None
               for n in FRAME)


def test_the_setup_readers_read_the_program_record(monkeypatch):
    from ttrt_torch.utils import profiling

    setup = profiling.SetupTimers()
    for name, (s, e) in {"before_program": (10.0, 10.5),
                         "import": (10.5, 12.0), "device": (12.25, 12.5),
                         "scene": (12.5, 13.0),
                         "first_frame": (14.0, 16.0)}.items():
        setup.mark(name, s, e)
    monkeypatch.setattr(profiling, "SETUP", setup)
    want = {"before_program": 0.5, "import": 1.5, "device": 0.25,
            "scene": 0.5, "first_frame": 2.0, "other": 1.25}
    for name in SETUP:
        got = harness._metric_reader(f"setup_{name}_s")(None)
        assert got == pytest.approx(want[name]), name
    # before the first frame's write, and without the record, nothing
    monkeypatch.setattr(profiling, "SETUP", profiling.SetupTimers())
    assert harness._metric_reader("setup_scene_s")(None) is None
    monkeypatch.delattr(profiling, "SETUP")
    assert all(harness._metric_reader(f"setup_{n}_s")(None) is None
               for n in SETUP)


def _span(host):
    """One frame over 10 ms: device busy 1-3 and 6-7 ms, so 7 ms idle in
    [0, 1), [3, 6) and [7, 10)."""
    dev = [("render_kernel<false>", 1000.0, 3000.0),
           ("Memcpy DtoH", 6000.0, 7000.0)]
    loop = [("stage:render+copy", 0.0, 7500.0),
            ("stage:encode+write", 7500.0, 9500.0),
            ("stage:pace", 9500.0, 10000.0)]
    return Span(0.0, 10000.0, 1, 0, dev, loop + host)


def test_idle_unspanned_reads_the_idle_time_no_program_span_covers(tiny):
    cell = cells.load_cell("demo.orbit", overrides=tiny)
    read = harness._metric_reader("idle_unspanned_pct")
    # pose covers 0-0.5 ms of idle; pack (2-4 ms, the kernel's tail) 1 ms;
    # copy on a pool thread overlaps pack (3.5-5 ms): 1 ms more; write
    # 8-9 ms: 1 ms. Covered 3.5 of 7 ms idle.
    host = [("stage:pose", 0.0, 500.0), ("stage:pack", 2000.0, 4000.0),
            ("stage:copy", 3500.0, 5000.0), ("stage:write", 8000.0, 9000.0),
            ("aten::mul", 5000.0, 6000.0)]
    rec = Record(cell, 1, {}, _span(host), list)
    assert read(rec) == pytest.approx(50.0)
    # every idle microsecond spanned; spans past the traced span are cut
    host = [("stage:pose", -500.0, 6000.0), ("stage:write", 7000.0, 11e3)]
    assert read(Record(cell, 1, {}, _span(host), list)) == pytest.approx(0.0)
    # the parent: only the loop's stages, so nothing to read
    assert read(Record(cell, 1, {}, _span([]), list)) is None
    assert read(Record(cell, 1, {}, None, list)) is None


def test_a_traced_cpu_run_reports_every_program_span_and_no_device_metric(
        tiny):
    run = harness.run_cell("demo.orbit", 2**31 + 17, 1.0, True, device="cpu",
                           overrides=tiny)
    got = set(run.line["metrics"])
    assert got == ({"encode_write_ms", "render_copy_ms"}
                   | {f"{n}_ms" for n in FRAME}
                   | {f"setup_{n}_s" for n in SETUP})
    m = {k: v["value"] for k, v in run.line["metrics"].items()}
    assert all(v >= 0 for v in m.values())
    step = sum(m[f"{n}_ms"] for n in FRAME[:6])
    assert step <= m["render_copy_ms"]
    assert m["encode_ms"] + m["write_ms"] <= m["encode_write_ms"]
