"""Run one cell of ``BENCHMARK.json`` once, from the root of a checkout:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The last line of standard output is the result, one JSON object; the
numbers the check compared, each beside its limit, are the last lines of
standard error. It exits 0 with a result, 2 on bad arguments or an
unknown cell, 3 without the CUDA devices the cell asks for, 4 when the
program cannot be imported, 5 when JAX, its libraries or the JAX package
were loaded, and 1 when the run failed; then it prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402


def _log(msg: str) -> None:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from benchmark import cells

    try:
        cell = cells.load_cell(args.workload)
    except (cells.UnknownCell, FileNotFoundError) as e:
        _log(f"unknown cell {args.workload!r}: {e}")
        return 2
    import torch

    chips = cell["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        _log(f"the cell needs {chips} CUDA device(s); "
             f"{torch.cuda.device_count()} available")
        return 3
    try:
        import ttrt_torch.app  # noqa: F401
    except ImportError as e:
        _log(f"the program does not import: {e}")
        return 4

    from benchmark import harness

    try:
        run = harness.run_cell(args.workload, args.seed, args.seconds,
                               bool(args.trace), device="cuda",
                               t_start=T_START)
    except Exception:  # the run failed: no result
        _log(traceback.format_exc())
        return 1
    banned = harness.banned_modules()
    if banned:
        _log(f"loaded modules of JAX or the JAX package: {banned}")
        return 5
    if not harness.finite(run.line):
        _log(f"a metric is not finite: {run.line['metrics']}")
        return 1
    print(json.dumps(run.line), flush=True)
    for line in harness.check_lines(run.checked):
        print(line, file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
