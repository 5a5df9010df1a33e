"""% of the window's frame steps that replayed a captured CUDA graph: the
program's own count, ``ttrt_torch.utils.profiling.STEPS`` (replayed and
eager steps on the card, started anew by each frame loop), read after the
window's loop in this process. None where the program keeps no such
count or counted no step."""

import sys


def read(record):
    profiling = sys.modules.get("ttrt_torch.utils.profiling")
    steps = getattr(profiling, "STEPS", None)
    if steps is None:
        return None
    total = steps.replayed + steps.eager
    return None if total == 0 else 100.0 * steps.replayed / total
