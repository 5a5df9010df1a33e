"""Seconds of set-up's 'before_program' phase: from the process's start
(``/proc/self/stat``, to 10 ms) to the first line of
``ttrt_torch/__init__.py``: the interpreter, and the harness's import of
torch. Read from the program's own record of its set-up,
``ttrt_torch.utils.profiling.SETUP``, in this process."""

from benchmark.metrics import _spans


def read(record):
    return _spans.setup_s("before_program")
