"""% of the window's path-traced frame steps that ran a path-tracing
kernel rather than the eager estimator: the program's own count,
``ttrt_torch.utils.profiling.PATH_STEPS`` (kernel and estimator steps,
started anew by each frame loop), read after the window's loop in this
process. None where the program keeps no such count or counted no
step."""

import sys


def read(record):
    profiling = sys.modules.get("ttrt_torch.utils.profiling")
    steps = getattr(profiling, "PATH_STEPS", None)
    if steps is None:
        return None
    total = steps.kernel + steps.estimator
    return None if total == 0 else 100.0 * steps.kernel / total
