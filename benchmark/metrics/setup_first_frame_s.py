"""Seconds of set-up's 'first_frame' phase: from the process's first
frame-step call to the end of that frame's write: the kernel library's
load and every first call. Read from the program's own record of its
set-up, ``ttrt_torch.utils.profiling.SETUP``, in this process."""

from benchmark.metrics import _spans


def read(record):
    return _spans.setup_s("first_frame")
