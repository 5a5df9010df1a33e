"""ms a frame in the program's 'launch' span over the window: the
kernel's launch: the output allocations, ``sky_table`` and the ctypes
call into the kernel library (its first ``build.load()`` included). The
program's own span, timed by the harness's stage clock."""

from benchmark.metrics import _spans


def read(record):
    return _spans.frame_ms(record, "launch")
