"""% of the window's physics steps that ran the physics step kernel rather
than the eager step: the program's own count,
``ttrt_torch.utils.profiling.PHYSICS_STEPS`` (kernel and eager steps,
started anew by each frame loop), read after the window's loop in this
process. None where the program keeps no such count or counted no step,
and where the process never used a card: on the CPU every step is the
eager one by construction, and the metric is a count of steps on the
card."""

import sys


def read(record):
    profiling = sys.modules.get("ttrt_torch.utils.profiling")
    steps = getattr(profiling, "PHYSICS_STEPS", None)
    torch = sys.modules.get("torch")
    if steps is None or torch is None or not torch.cuda.is_initialized():
        return None
    total = steps.kernel + steps.eager
    return None if total == 0 else 100.0 * steps.kernel / total
