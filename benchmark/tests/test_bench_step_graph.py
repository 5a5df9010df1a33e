"""The reader of the program's step count, ``step_graph_pct``: its entry in
``BENCHMARK.json``, the share it reads from the program's ``STEPS``, and
nothing where the program counted no step or keeps no such count."""

import pytest

from benchmark import cells, harness

CELLS = ["demo.orbit", "demo.batch8", "many10k.orbit"]


def test_the_metric_is_declared_for_the_graphed_cells():
    spec = {m["name"]: m for m in cells.load_spec()["per_layer"]}
    m = spec["step_graph_pct"]
    assert (m["unit"], m["better"], m["source"]) == (
        "%", "higher", "program_counter")
    assert (m["layer"], m["moves"], m["workloads"]) == (
        "frame step and copy", "fps", CELLS)
    assert "step_graph_pct" not in {
        x["name"] for x in cells.load_cell("physics.drop")["per_layer"]}


def test_the_reader_reads_the_share_of_replayed_steps(monkeypatch):
    from ttrt_torch.utils import profiling

    read = harness._metric_reader("step_graph_pct")
    steps = profiling.StepCounts()
    monkeypatch.setattr(profiling, "STEPS", steps)
    steps.replayed, steps.eager = 999, 1
    assert read(None) == pytest.approx(99.9)
    steps.replayed, steps.eager = 0, 4
    assert read(None) == 0.0
    # no step counted (a loop on the CPU), and the parent's program
    steps.reset()
    assert read(None) is None
    monkeypatch.delattr(profiling, "STEPS")
    assert read(None) is None
