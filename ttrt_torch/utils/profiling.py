"""Frame metrics (port of ``ttrt.utils.profiling``).

The reference's only instrumentation is the fps printout
(TerminalRayTracer.c:1362-1365). Here:

  - StageTimers: per-stage wall-time accumulators (render+copy,
    encode+write, pace) with p50/p95 summaries, logged to stderr; stdout IS
    the framebuffer.
  - FrameMeter: an fps exponential moving average.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional

from ttrt_torch.utils.logging import log


class StageTimers:
    """Accumulate wall-clock samples per named stage."""

    def __init__(self, max_samples: int = 4096):
        self._samples: Dict[str, List[float]] = defaultdict(list)
        self._max = max_samples

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            s = self._samples[name]
            if len(s) < self._max:
                s.append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, s in self._samples.items():
            if not s:
                continue
            ss = sorted(s)
            n = len(ss)
            out[name] = {
                "n": n,
                "mean_ms": 1e3 * sum(ss) / n,
                "p50_ms": 1e3 * ss[n // 2],
                "p95_ms": 1e3 * ss[min(n - 1, int(n * 0.95))],
                "total_s": sum(ss),
            }
        return out

    def log_summary(self) -> None:
        for name, st in sorted(self.summary().items()):
            log(
                f"stage {name:>10}: mean {st['mean_ms']:7.3f} ms  "
                f"p50 {st['p50_ms']:7.3f}  p95 {st['p95_ms']:7.3f}  "
                f"(n={st['n']})"
            )


class FrameMeter:
    """EMA fps meter for the ``--stats`` summary line."""

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.fps: Optional[float] = None

    def update(self, frame_seconds: float):
        fps = 1.0 / max(frame_seconds, 1e-9)
        self.fps = fps if self.fps is None else (
            self.alpha * fps + (1 - self.alpha) * self.fps
        )
        return self

    def hud(self) -> str:
        return "" if self.fps is None else f"{self.fps:.02f} fps"
