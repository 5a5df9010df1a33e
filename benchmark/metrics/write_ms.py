"""ms a frame in the program's 'write' span over the window:
``disp.write_frame``: the frame's bytes (``tobytes``) and the write to
the terminal. The program's own span, timed by the harness's stage
clock."""

from benchmark.metrics import _spans


def read(record):
    return _spans.frame_ms(record, "write")
