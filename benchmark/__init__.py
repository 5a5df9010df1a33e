"""The benchmark of the PyTorch and CUDA port, ``ttrt_torch``: one cell
(a scene configuration under a frame stream) run once a call,
``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``, from the root of a checkout.

Cells, configurations and per-layer metrics are data: ``BENCHMARK.json``
names them, and the harness finds ``workloads/<cell>.json``,
``configs/<config>.json``, ``scenes/<kind>.py``,
``reference/<kind>.py``, ``reference/sky_<sky>.py``,
``reference/<renderer>.py`` and ``metrics/<metric>.py`` by those names.
"""
