"""Seconds of set-up's 'scene' phase: the first scene build
(``app.make_scene``, or ``many_sphere_scene``). Read from the program's
own record of its set-up, ``ttrt_torch.utils.profiling.SETUP``, in this
process."""

from benchmark.metrics import _spans


def read(record):
    return _spans.setup_s("scene")
