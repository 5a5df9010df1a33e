"""ms a frame in the program's 'encode' span over the window: the host's
ANSI expansion of the frame (the native C encoder). The program's own
span, timed by the harness's stage clock."""

from benchmark.metrics import _spans


def read(record):
    return _spans.frame_ms(record, "encode")
