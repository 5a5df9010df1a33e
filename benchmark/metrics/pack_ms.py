"""ms a frame in the program's 'pack' span over the window: the scene
packed for the kernel: ``kernels/render.py::_scene_buffer``;
``pack_scene``, ``pack_area_lights`` and the ``cat`` in
``kernels/pathtrace.py``; the visit order, camera and lights in
``kernels/mesh_fused.py``. The program's own span, timed by the
harness's stage clock."""

from benchmark.metrics import _spans


def read(record):
    return _spans.frame_ms(record, "pack")
