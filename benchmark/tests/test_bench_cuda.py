"""On the card (marker ``cuda``; skipped without one): a short run of
each cell at its full size through the harness, correct; its traced
metrics; and the control at full size failing a limit."""

import pytest
import torch

from benchmark import cells, control, harness


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["demo.orbit", "many10k.orbit",
                                  "demo.batch8", "physics.drop"])
def test_a_short_run_on_the_card_is_correct_and_traced(cell, card):
    # 9 s: the 10k cell's profiled span starts after frame 20 and holds
    # 50 frames, at ~11.5 frames a second; physics.drop's 20 after frame
    # 20 run at 10-20 frames a second, slower under the profiler
    seconds = 15.0 if cell == "physics.drop" else 9.0
    run = harness.run_cell(cell, 2**31 + 1234, seconds, True, device=card)
    line = run.line
    assert line["correct"] is True, line["check"]
    assert line["device"]["platform"] == "gpu"
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
    for m in run.cell["per_layer"]:
        assert m["name"] in line["metrics"], m["name"]
        v = line["metrics"][m["name"]]["value"]
        assert v > 0 and (not m["unit"] == "%" or v <= 100.0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["demo.orbit", "physics.drop"])
def test_the_control_at_full_size_is_not_correct(cell, card):
    """The reference in bfloat16 in the program's place, through the
    whole run: its check reports the run as not correct."""
    from ttrt_torch import app

    seed = 2**31 + 4321
    with control.Planted(app, cells.load_cell(cell), seed, card):
        run = harness.run_cell(cell, seed, 2.0, False, device=card)
    assert run.line["correct"] is False, run.line["check"]
    assert any(run.line["check"][n]["value"] > run.line["check"][n]["limit"]
               for n in harness.LIMITED), run.line["check"]
