"""ms a frame in the program's 'pose' span over the window: the orbit
camera's pose and the posed scene (``app._posed``:
``orbit_camera_frame``, ``with_camera_frame``). The program's own span,
timed by the harness's stage clock."""

from benchmark.metrics import _spans


def read(record):
    return _spans.frame_ms(record, "pose")
