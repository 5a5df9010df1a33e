"""Structured logging to STDERR (port of ``ttrt.utils.logging``).

stdout is the framebuffer (the terminal IS the display device), so all
diagnostics go to stderr — the reference instead interleaves error printfs
with frame data on stdout (e.g. TerminalRayTracer.c:320).
"""

from __future__ import annotations

import sys
import time

_T0 = time.monotonic()


def log(msg: str, *, level: str = "INFO") -> None:
    print(
        f"[ttrt_torch {level} +{time.monotonic() - _T0:8.3f}s] {msg}",
        file=sys.stderr,
        flush=True,
    )
