"""Seconds of set-up's 'other' phase: what the five phases leave of the
time from the process's start to the end of its first frame's write: the
harness's own steps between them (in a traced run its profiler warm-up
too). Read from the program's own record of its set-up,
``ttrt_torch.utils.profiling.SETUP``, in this process."""

from benchmark.metrics import _spans


def read(record):
    return _spans.setup_s("other")
