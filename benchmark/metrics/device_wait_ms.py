"""ms a frame in the program's 'device_wait' span over the window:
``app._to_host``'s wait for the frame buffer's stream: the device's work
the host waits for. The program's own span, timed by the harness's stage
clock."""

from benchmark.metrics import _spans


def read(record):
    return _spans.frame_ms(record, "device_wait")
