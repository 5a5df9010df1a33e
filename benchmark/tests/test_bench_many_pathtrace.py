"""The path-traced many-object cell, many10k_pt.orbit, on the CPU at a tiny
size: the cell runs and reads correct with the program's plain version,
the control (the reference in bfloat16) fails it, the roofline's floor
is hand-counted and never over the dense count, its readers read a
recorded span, and the new reference imports nothing of the program;
on the card (marker ``cuda``), a short traced run at full size."""

import json
import subprocess
import sys

import pytest
import torch

from benchmark import cells, control, harness
from benchmark.metrics import _roofline, _roofline_mesh_pt
from benchmark.trace import Record, Span

CELL = "many10k_pt.orbit"


def test_the_cell_runs_on_the_cpu_and_reads_correct(tiny):
    run = harness.run_cell(CELL, 2**31 + 5, 1.0, False, device="cpu",
                           overrides=tiny)
    line = json.loads(json.dumps(run.line))
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["metrics"]) == {"fps", "latency_ms_p95", "setup_s"}
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert line["check"]["frames_checked"]["value"] >= 2
    assert not run.sink.bad_frames


def test_the_control_in_the_program_place_is_not_correct(tiny):
    from ttrt_torch import app

    seed = 2**31 + 8
    with control.Planted(app, cells.load_cell(CELL, overrides=tiny), seed,
                         "cpu"):
        run = harness.run_cell(CELL, seed, 0.5, False, device="cpu",
                               overrides=tiny)
    assert run.line["correct"] is False and run.line["failed"] >= 1
    assert any(run.line["check"][n]["value"] > run.line["check"][n]["limit"]
               for n in harness.LIMITED), run.line["check"]


def test_the_roofline_floor_is_hand_counted_and_under_the_dense_count():
    """A tiny frame's work, (nearest-hit traces, hits, unblocked shadow
    rays) = (30, 20, 12) over 8 paths and one light, counted by hand; and
    on the reference's own work the floor stays under what a dense walk
    must do: every object tested by every ray."""
    want = (30 * (20 + 13) + 20 * (35 + 23 + 61) + 10 * 10
            + 20 * (13 + 13) + 8 * 129)
    assert _roofline_mesh_pt.ops((30, 20, 12), 1, 8) == want
    nbytes = 5 * 40 + 2 * 88 + 4 * (17 + 8) + 20 * 4
    assert _roofline_mesh_pt.frame_bound_ms((30, 20, 12), 5, 2, 1, 4, 8) \
        == _roofline.bound_ms(want, nbytes)
    from benchmark.reference import many_pathtrace, sky_colors

    config = {**cells.load_cell(CELL)["config"], "width": 12, "height": 6,
              "spp": 2, "bounces": 4, "n_spheres": 40}
    scene = many_pathtrace.build(config, dtype=torch.float32, device="cpu")
    _, work = many_pathtrace.render(scene, sky_colors.build(config,
                                                            device="cpu"),
                                    config, 0.3, 9, dtype=torch.float32,
                                    device="cpu")
    nearest, hits, _ = work
    n_obj = 40 + 512
    dense = (_roofline_mesh_pt.ops(work, 1, 144)
             + (nearest + hits) * (n_obj - 1) * _roofline_mesh_pt.NARROW_OPS)
    assert 0 < _roofline_mesh_pt.ops(work, 1, 144) < dense


def test_the_readers_read_a_recorded_span(tiny):
    """Two frames, the kernel 50 ms each: its time a frame, its share of
    the floor of the reference's work, and the program's route count."""
    dev = [("pathtrace_mesh_kernel<true, false>", 0.0, 50000.0),
           ("pathtrace_mesh_kernel<true, false>", 60000.0, 110000.0)]
    span = Span(0.0, 120000.0, 2, 4, dev,
                [("stage:encode+write", 0.0, 120000.0)])
    cell = cells.load_cell(CELL, overrides=tiny)
    rec = Record(cell, 2, {}, span, lambda: [(300, 200, 90), (310, 190, 80)])
    read = harness._metric_reader
    assert read("pathtrace_mesh_kernel_ms")(rec) == pytest.approx(50.0)
    c = cell["config"]
    n_px = c["width"] * c["height"]
    bound = sum(_roofline_mesh_pt.frame_bound_ms(
        w, c["n_spheres"], 512, 1, n_px, n_px * c["spp"])
        for w in [(300, 200, 90), (310, 190, 80)]) / 2
    assert read("pathtrace_mesh_kernel_roofline")(rec) == pytest.approx(
        100 * bound / 50.0)
    assert read("mesh_fused_kernel_ms")(rec) is None
    from ttrt_torch.utils import profiling

    profiling.PATH_STEPS.kernel, profiling.PATH_STEPS.estimator = 3, 1
    assert read("pathtrace_kernel_pct")(rec) == 75.0
    profiling.PATH_STEPS.reset()
    assert read("pathtrace_kernel_pct")(rec) is None
    rec = Record(cell, 2, {}, None, list)
    assert read("pathtrace_mesh_kernel_ms")(rec) is None
    assert read("pathtrace_mesh_kernel_roofline")(rec) is None


def test_the_new_reference_imports_nothing_of_the_program():
    code = ("import sys\nimport benchmark.reference.many_pathtrace\n"
            "print('\\n'.join(sorted(sys.modules)))")
    r = subprocess.run([sys.executable, "-c", code], cwd=cells.ROOT,
                       capture_output=True, text=True, timeout=300,
                       check=True)
    tops = {m.split(".")[0] for m in r.stdout.split()}
    assert "benchmark" in tops
    assert not tops & {"ttrt_torch", "ttrt", "jax", "jaxlib"}


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct_and_traced():
    """On the card (marker ``cuda``): a 4-s traced run at full size reads
    correct and reports the cell's three per-layer metrics, the shares in
    (0, 100]."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    run = harness.run_cell(CELL, 2**31 + 1234, 4.0, True, device="cuda")
    line = run.line
    assert line["correct"] is True, line["check"]
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
    for m in run.cell["per_layer"]:
        v = line["metrics"][m["name"]]["value"]
        assert v > 0 and (m["unit"] != "%" or v <= 100.0), (m["name"], v)
