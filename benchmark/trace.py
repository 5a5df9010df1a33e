"""The traced run's record: torch.profiler over a steady span of the
window, the stages' host-clock totals, and what the per-layer readers
(``metrics/<metric>.py``) read from them.

The profiler starts after the window's frame ``skip`` and stops after
``frames`` more, inside the sink's frame hook. The span runs from the
first stage the profiler sees (the pace after frame ``skip``) to the end
of the last frame's write, so it holds exactly ``frames`` turns of the
loop. When the profiler delivers no device events for a span (CUPTI's
trace is not always delivered), the next frames are profiled again, up
to ``tries`` spans.
"""

from __future__ import annotations

import heapq
import time
from typing import Callable, Dict, List, NamedTuple, Optional

import torch

COPY_PREFIXES = ("Memcpy", "Memset")


class Span(NamedTuple):
    start_us: float
    end_us: float
    frames: int
    first_frame: int  # the window's index of the span's first frame
    device: List[tuple]  # (name, start_us, end_us) of each device op
    host: List[tuple]  # (name, start_us, end_us) of each host event

    @property
    def seconds(self) -> float:
        return (self.end_us - self.start_us) * 1e-6

    def kernels(self) -> List[tuple]:
        """The CUDA kernels (no copies, no fills) that start in the span."""
        return [e for e in self.device
                if not e[0].startswith(COPY_PREFIXES)
                and self.start_us <= e[1] <= self.end_us]

    def busy(self) -> List[tuple]:
        """The union of device activity inside the span, as merged
        (start, end) intervals."""
        iv = sorted((max(s, self.start_us), min(e, self.end_us))
                    for _, s, e in self.device
                    if e > self.start_us and s < self.end_us)
        out: List[list] = []
        for s, e in iv:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [tuple(x) for x in out]

    def busy_seconds(self) -> float:
        return sum(e - s for s, e in self.busy()) * 1e-6

    def kernel_ms(self, name: str) -> Optional[float]:
        """ms a frame of the kernels whose name holds ``name``: their
        total time in the span over its frames, however many launches a
        frame makes; None without one."""
        ks = [e for e in self.kernels() if name in e[0]]
        if not ks:
            return None
        return sum(e[2] - e[1] for e in ks) * 1e-3 / self.frames


def parse(prof, frames: int, first_frame: int) -> Optional[Span]:
    """The span of a stopped profiler, or None without stage events."""
    device, host = [], []
    for e in prof.events():
        row = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type != torch.autograd.DeviceType.CUDA:
            host.append(row)
        elif not e.name.startswith("stage:"):
            # the stage ranges' device-side annotations are no device work
            device.append(row)
    stages = [h for h in host if h[0].startswith("stage:")]
    writes = [h for h in stages if h[0] == "stage:encode+write"]
    if not writes:
        return None
    return Span(min(h[1] for h in stages), max(h[2] for h in writes), frames,
                first_frame, device, host)


def activities() -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def warm_profiler(device) -> None:
    """Start and stop the profiler once around a device op, so that its
    first start (CUPTI's set-up, seconds) falls in set-up, not in the
    window."""
    with torch.profiler.profile(activities=activities()):
        torch.ones(1, device=device).add_(1)
        if device.type == "cuda":
            torch.cuda.synchronize(device)


class Tracer:
    """Profiles ``frames`` frames after frame ``skip`` of the window (the
    sink's ``on_frame`` hook)."""

    def __init__(self, skip: int, frames: int, tries: int = 3):
        self.start_at = skip
        self.frames = frames
        self.tries = tries
        self.span: Optional[Span] = None
        self._prof = None
        self._first = 0
        self.read_s = 0.0  # seconds the window spent stopping and parsing

    def on_frame(self, i: int) -> None:
        if self.span is not None or self.tries == 0:
            return
        if self._prof is None and i == self.start_at:
            self._prof = torch.profiler.profile(activities=activities())
            self._prof.start()
            self._first = i + 1
        elif self._prof is not None and i == self._first + self.frames - 1:
            t0 = time.perf_counter()
            self._prof.stop()
            span = parse(self._prof, self.frames, self._first)
            self.read_s += time.perf_counter() - t0
            self._prof = None
            self.tries -= 1
            if span is not None and span.device:
                self.span = span
            else:
                self.start_at = i + 1

    def close(self) -> None:
        """Drop a span the window's end cut short."""
        if self._prof is not None:
            self._prof.stop()
            self._prof = None


class Record:
    """What a per-layer reader reads: the cell, the window's frames and
    stage samples, the traced span (None when the profiler gave no device
    events), ``profiled_work()``: the reference's work count of each
    frame of the span, and ``end_to_end``: the traced run's own
    end-to-end numbers by name, as the harness computes them in every
    run."""

    def __init__(self, cell: dict, frames: int, stages: Dict[str, list],
                 span: Optional[Span], profiled_work: Callable[[], list],
                 end_to_end: Optional[Dict[str, float]] = None):
        self.cell = cell
        self.config = cell["config"]
        self.workload = cell["workload"]
        self.frames = frames
        self.stages = stages
        self.span = span
        self.end_to_end = end_to_end or {}
        self._work_fn = profiled_work
        self._work = None

    def stage_total(self, name: str) -> Optional[float]:
        s = self.stages.get(name)
        return sum(s) if s else None

    def profiled_work(self) -> list:
        if self._work is None:
            self._work = self._work_fn()
        return self._work


def _around(times: List[float], host: List[tuple]) -> List[List[tuple]]:
    """For each of the increasing ``times``, the host events that hold it
    (start <= time <= end), in ``host``'s order: one sweep over the events
    by start with a heap of the open ones by end, so that a span of many
    thousands of launches and gaps is read in seconds."""
    order = sorted(range(len(host)), key=lambda i: host[i][1])
    open_: List[tuple] = []  # (end, index)
    out, k = [], 0
    for t in times:
        while k < len(order) and host[order[k]][1] <= t:
            heapq.heappush(open_, (host[order[k]][2], order[k]))
            k += 1
        while open_ and open_[0][0] < t:
            heapq.heappop(open_)
        out.append([host[i] for i in sorted(i for _, i in open_)])
    return out


def breakdown(span: Span, top: int = 10) -> dict:
    """The device ops that took most time in the span, and the idle time
    by what the host was doing: the stage the gap lies in and the
    shortest host event around the gap's middle ("host code" where no
    event was recorded there: Python, or C called through ctypes)."""
    by_op: Dict[str, float] = {}
    for name, s, e in span.device:
        if span.start_us <= s <= span.end_us:
            by_op[name[:120]] = by_op.get(name[:120], 0.0) + (e - s) * 1e-6
    gaps, t = [], span.start_us
    for s, e in span.busy() + [(span.end_us, span.end_us)]:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    idle: Dict[str, float] = {}
    for (g0, g1), around in zip(gaps, _around([0.5 * (g0 + g1)
                                               for g0, g1 in gaps],
                                              span.host)):
        stage = [h[0][6:] for h in around if h[0].startswith("stage:")]
        ops = sorted((h for h in around if not h[0].startswith("stage:")),
                     key=lambda h: h[2] - h[1])
        label = (f"{stage[0] if stage else 'between stages'}/"
                 f"{ops[0][0][:80] if ops else 'host code'}")
        idle[label] = idle.get(label, 0.0) + (g1 - g0) * 1e-6

    def ranked(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                ][:top]

    return {"device_ops": ranked(by_op), "idle_gaps": ranked(idle)}
