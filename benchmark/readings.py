"""The readings a cell's correctness limits are set from, at the cell's
own size, in one process:

    python3 -m benchmark.readings --workload <cell> --seconds <s> \\
        --seeds <n> ... [--control-seeds <n> ...]

For each of ``--seeds`` it runs the cell as a run does (set-up, a window
of ``--seconds``, the check) and prints the numbers compared: the lower
reading is the largest over the seeds. For each of ``--control-seeds``
it runs the cell again with the control planted in the program's place
(``control.Planted``: the reference in bfloat16) and prints the same
numbers and the run's ``correct``: the upper reading is the smallest. One
JSON line a run on standard output. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmark import cells, control, harness


def reading(workload: str, seed: int, seconds: float,
            planted: bool) -> dict:
    """One run's numbers: the check's, each frame's, and the metrics."""
    t0 = time.perf_counter()
    if planted:
        from ttrt_torch import app

        with control.Planted(app, cells.load_cell(workload), seed, "cuda"):
            run = harness.run_cell(workload, seed, seconds, False,
                                   device="cuda")
    else:
        run = harness.run_cell(workload, seed, seconds, False, device="cuda")
    return {"workload": workload, "seed": seed, "control": planted,
            "correct": run.line["correct"], "checked": run.line["check"],
            "frames": [[f["frame"], f["t"], f["mean_abs_diff"],
                        f["far_px_pct"], f["diff_px_pct"]]
                       for f in run.compared],
            "metrics": {k: v["value"]
                        for k, v in run.line["metrics"].items()},
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark.readings")
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("benchmark.readings: no CUDA device", file=sys.stderr)
        return 3
    runs = ([(s, False) for s in args.seeds]
            + [(s, True) for s in args.control_seeds])
    for seed, planted in runs:
        print(json.dumps(reading(args.workload, seed, args.seconds,
                                 planted)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
