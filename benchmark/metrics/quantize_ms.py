"""ms a frame in the program's 'quantize' span over the window: the
frame quantized on the device: ``encode_rgb_frame``, or with ``--encode
device`` ``encode_ansi_frame``. The program's own span, timed by the
harness's stage clock."""

from benchmark.metrics import _spans


def read(record):
    return _spans.frame_ms(record, "quantize")
