"""ms a frame in the program's 'physics' stage over the window: the
frame's physics substeps (``physics/world.py::physics_step``: the
integration, the batched GJK query of every pair, the contact impulses
and corrections, the ground and the walls), which
``physics/demo.py::build_physics_frame_step`` opens on the timers
``run_physics`` passes. The program's own span, timed by the harness's
stage clock."""

from benchmark.metrics import _spans


def read(record):
    return _spans.frame_ms(record, "physics")
