"""What the readers of the program's own spans share: a frame span's ms a
frame over the window, from the harness's stage clock (the program's
``profiling.span`` opens each span as a stage of the timers the loop was
given), and a set-up phase's seconds from the program's own record,
``ttrt_torch.utils.profiling.SETUP``, in this process. Each is None where
the program has no such span or record."""

from __future__ import annotations

import sys


def frame_ms(record, name: str):
    """ms a frame in the span ``name`` over the window's frames."""
    total = record.stage_total(name)
    return None if total is None else 1e3 * total / record.frames


def setup_s(phase: str):
    """Seconds of set-up's ``phase`` (or 'other') in this process."""
    profiling = sys.modules.get("ttrt_torch.utils.profiling")
    setup = getattr(profiling, "SETUP", None)
    if setup is None:
        return None
    return setup.phases().get(phase)
