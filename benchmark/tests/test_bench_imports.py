"""What a run loads: no JAX, no JAX library, not the JAX package ``ttrt``
(compared by whole top-level names: the port's ``ttrt_torch`` begins with
``ttrt``), and in the reference nothing of the program."""

import subprocess
import sys
from pathlib import Path

from benchmark import cells, harness

HARNESS = ["benchmark.run", "benchmark.harness", "benchmark.readings",
           "benchmark.control", "benchmark.window", "benchmark.trace",
           "ttrt_torch.app"]


def _loaded(imports, extra=""):
    code = ("import sys\n" + "".join(f"import {m}\n" for m in imports)
            + extra + "print('\\n'.join(sorted(sys.modules)))")
    r = subprocess.run([sys.executable, "-c", code], cwd=cells.ROOT,
                       capture_output=True, text=True, timeout=300,
                       check=True)
    return r.stdout.split()


def test_the_harness_loads_no_jax_and_not_the_jax_package():
    readers = "".join(
        f"harness._metric_reader({p.stem!r})\n"
        for p in sorted((cells.HERE / "metrics").glob("[!_]*.py")))
    mods = _loaded(HARNESS + ["benchmark.scenes.demo",
                              "benchmark.scenes.many",
                              "benchmark.scenes.physics"],
                   "from benchmark import harness\n" + readers)
    tops = {m.split(".")[0] for m in mods}
    assert "ttrt_torch" in tops
    assert not tops & set(harness.BANNED), sorted(tops & set(harness.BANNED))


def test_the_reference_loads_nothing_of_the_program():
    ref = sorted(p.stem for p in (cells.HERE / "reference").glob("*.py")
                 if p.stem != "__init__")
    mods = _loaded([f"benchmark.reference.{m}" for m in ref])
    assert not [m for m in mods if m.split(".")[0] in
                ("ttrt_torch", "ttrt", "jax")]


def test_the_benchmark_copies_and_does_not_import_the_port_bench():
    for path in Path(cells.HERE).rglob("*.py"):
        if path.parent.name == "tests":
            continue
        src = path.read_text()
        for name in ("ttrt_torch.bench", "ttrt_torch import bench",
                     "chip_smoke", "import bench\n"):
            assert name not in src, (path, name)
