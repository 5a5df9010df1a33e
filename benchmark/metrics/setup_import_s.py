"""Seconds of set-up's 'import' phase: from the first line of
``ttrt_torch/__init__.py`` to the end of ``ttrt_torch/app.py``'s module
body, the native library's load included. Read from the program's own
record of its set-up, ``ttrt_torch.utils.profiling.SETUP``, in this
process."""

from benchmark.metrics import _spans


def read(record):
    return _spans.setup_s("import")
