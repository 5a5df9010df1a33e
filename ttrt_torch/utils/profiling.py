"""Frame metrics (port of ``ttrt.utils.profiling``).

The reference's only instrumentation is the fps printout
(TerminalRayTracer.c:1362-1365). Here:

  - StageTimers: per-stage wall-time accumulators (render+copy,
    encode+write, pace) with p50/p95 summaries, logged to stderr; stdout IS
    the framebuffer.
  - FrameMeter: fps and Mray/s exponential moving averages for the HUD.
  - profile_trace: a torch.profiler trace of CPU and CUDA activity around
    a block, written as a Chrome trace (--profile DIR in the CLI).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional

import torch

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

    def record(self, name: str, seconds: float) -> None:
        """Add one sample measured elsewhere (a device time, say)."""
        s = self._samples[name]
        if len(s) < self._max:
            s.append(seconds)

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
    """EMA fps and ray-throughput meter for the HUD line."""

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.fps: Optional[float] = None
        self.mrays: Optional[float] = None

    def update(self, frame_seconds: float, rays: Optional[int] = None):
        fps = 1.0 / max(frame_seconds, 1e-9)
        self.fps = fps if self.fps is None else (
            self.alpha * fps + (1 - self.alpha) * self.fps
        )
        if rays is not None:
            mr = rays / max(frame_seconds, 1e-9) / 1e6
            self.mrays = mr if self.mrays is None else (
                self.alpha * mr + (1 - self.alpha) * self.mrays
            )
        return self

    def hud(self) -> str:
        parts = []
        if self.fps is not None:
            parts.append(f"{self.fps:.02f} fps")
        if self.mrays is not None:
            parts.append(f"{self.mrays:.0f} Mray/s")
        return "  ".join(parts)


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]) -> Iterator[None]:
    """A torch.profiler trace of the block, CPU activity and, with a card,
    CUDA activity, written to ``log_dir/trace.json`` as a Chrome trace
    (chrome://tracing, Perfetto), or under a launcher that sets RANK to
    ``log_dir/trace_rank<RANK>.json``; a no-op when ``log_dir`` is
    None."""
    if not log_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    rank = os.environ.get("RANK")
    path = os.path.join(log_dir, TRACE_FILE if rank is None
                        else f"trace_rank{rank}.json")
    prof.export_chrome_trace(path)
    log(f"wrote torch.profiler trace to {path}")
