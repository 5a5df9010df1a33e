"""ms a frame in the program's 'copy' span over the window:
``app._to_host``'s copy of the frame to the host (``.cpu().numpy()``).
The program's own span, timed by the harness's stage clock."""

from benchmark.metrics import _spans


def read(record):
    return _spans.frame_ms(record, "copy")
