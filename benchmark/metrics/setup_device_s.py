"""Seconds of set-up's 'device' phase: the program's first touch of the
card: the CUDA runtime's start and the context's creation. Read from the
program's own record of its set-up,
``ttrt_torch.utils.profiling.SETUP``, in this process."""

from benchmark.metrics import _spans


def read(record):
    return _spans.setup_s("device")
