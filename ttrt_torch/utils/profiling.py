"""Frame metrics and spans (port of ``ttrt.utils.profiling``).

The reference's only instrumentation is the fps printout
(TerminalRayTracer.c:1362-1365). Here:

  - StageTimers: per-stage wall-time accumulators (render+copy,
    encode+write, pace, and the frame spans below) with p50/p95
    summaries, logged to stderr; stdout IS the framebuffer. While a
    torch.profiler runs, each stage is also a ``record_function`` range of
    its name, so a Chrome trace shows it on the kernels' timeline.
  - span(name): the stage ``name`` of the timers that the running frame
    loop installed (``recording``), or one shared no-op context while no
    loop records. The frame steps open ``pose``, ``pack``, ``launch``,
    ``quantize``, ``device_wait``, ``copy``, ``encode`` and ``write``.
  - SETUP: the process's set-up, phase by phase, from its start to the
    end of its first frame's write (``SetupTimers``).
  - STEPS: how the running loop's frame steps on a CUDA device ran:
    replayed from a captured CUDA graph, or eagerly (``StepCounts``).
  - PATH_STEPS: the route each of the running loop's path-traced frame
    steps took: a path-tracing kernel, or the eager estimator
    (``PathStepCounts``).
  - PHYSICS_STEPS: the route each physics step took: the physics step
    kernel, or the eager step (``PhysicsStepCounts``).
  - profile_trace: a torch.profiler trace of CPU and CUDA activity around
    a block, written as a Chrome trace (--profile DIR in the CLI).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional, Tuple

import torch

from ttrt_torch.utils.logging import log

# the module whose flag torch.profiler sets while it records
_autograd_profiler = torch.autograd.profiler

NO_SPAN = contextlib.nullcontext()


class StageTimers:
    """Accumulate wall-clock samples per named stage."""

    def __init__(self, max_samples: int = 4096):
        self._samples: Dict[str, List[float]] = defaultdict(list)
        self._max = max_samples

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        marker = (torch.profiler.record_function(name)
                  if _autograd_profiler._is_profiler_enabled else NO_SPAN)
        t0 = time.perf_counter()
        try:
            with marker:
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


# the timers of the frame loop that is running, read by span(); a module
# global, not a thread-local: the pipelined copies run in pool threads
_recorder: Optional[StageTimers] = None


def span(name: str):
    """The stage ``name`` of the running loop's timers; without a loop
    recording, one shared no-op context (no clock read, no allocation)."""
    rec = _recorder
    return NO_SPAN if rec is None else rec.stage(name)


class StepCounts:
    """The frame steps of the running loop on a CUDA device: ``replayed``,
    each a replay of the step's captured CUDA graph (``step_graph``), and
    ``eager``, each run op by op (a graphed step's first call included).
    Steps on the CPU are not counted."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.replayed = 0
        self.eager = 0


STEPS = StepCounts()


class PathStepCounts:
    """The path-traced frame steps of the running loop (``--pathtrace``)
    by route, on any device: ``kernel``, each through a path-tracing
    kernel (its plain version on the CPU), and ``estimator``, each through
    the eager Monte-Carlo estimator."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.kernel = 0
        self.estimator = 0


PATH_STEPS = PathStepCounts()


class PhysicsStepCounts:
    """The physics steps (``physics/world.py::physics_step``) by route, on
    any device: ``kernel``, each one launch of the physics step kernel, and
    ``eager``, each through the eager step (``physics_step_plain``)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.kernel = 0
        self.eager = 0


PHYSICS_STEPS = PhysicsStepCounts()


@contextlib.contextmanager
def recording(timers) -> Iterator[None]:
    """Make ``timers`` (anything with ``stage(name)``) the recorder of
    ``span`` for the block, then restore the one installed before. The
    block is a frame loop: ``STEPS``, ``PATH_STEPS`` and ``PHYSICS_STEPS``
    start anew with it and keep their counts after it, until the next
    loop."""
    global _recorder
    STEPS.reset()
    PATH_STEPS.reset()
    PHYSICS_STEPS.reset()
    saved, _recorder = _recorder, timers
    try:
        yield
    finally:
        _recorder = saved


# set-up's phases, in the order a process meets them; 'other' is what they
# leave of the time from the process's start to its first frame's write
PHASES = ("before_program", "import", "device", "scene", "first_frame")


class SetupTimers(StageTimers):
    """The process's set-up: each phase timed the first time it occurs,
    as an interval on the host clock (``time.perf_counter``).

    - ``before_program``: the process's start (``process_start``) to the
      first line of ``ttrt_torch/__init__.py``: the interpreter, and
      whatever imported torch first;
    - ``import``: that line to the end of ``ttrt_torch.app``'s module body;
    - ``device``: the program's first touch of a device (``touch_device``):
      the CUDA context's creation; empty where the context was there or the
      device is the CPU;
    - ``scene``: the first scene build;
    - ``first_frame``: the process's first frame-step call to the end of
      that frame's write."""

    def __init__(self):
        super().__init__()
        # name -> (start, end); end None while its setup_span is open
        self.spans: Dict[str, Tuple[float, Optional[float]]] = {}

    def start(self, name: str) -> Optional[float]:
        """The host clock now, or None once ``name`` is recorded: the start
        to hand ``mark`` at the end of a phase that no block encloses."""
        return None if name in self.spans else time.perf_counter()

    def mark(self, name: str, start: float, end: Optional[float] = None
             ) -> None:
        """Record the phase ``name`` as [start, end) (end: now), unless it
        was recorded before."""
        if name not in self.spans:
            end = time.perf_counter() if end is None else end
            self.spans[name] = (start, end)
            self._samples[name].append(end - start)

    def setup_span(self, name: str):
        """A context that records the phase ``name`` over its block the
        first time it occurs; the shared no-op after, and inside it."""
        return NO_SPAN if name in self.spans else self._span(name)

    @contextlib.contextmanager
    def _span(self, name: str) -> Iterator[None]:
        self.spans[name] = (time.perf_counter(), None)
        try:
            yield
        finally:
            self.mark(name, self.spans.pop(name)[0])

    def phases(self) -> Dict[str, float]:
        """Seconds of each phase that ended by the end of the first frame's
        write, and 'other': the rest of the time from the earliest phase's
        start to that end. Empty before the first frame's write."""
        if "first_frame" not in self.spans:
            return {}
        end = self.spans["first_frame"][1]
        spans = {n: se for n, se in self.spans.items()
                 if se[1] is not None and se[1] <= end}
        out = {n: e - s for n, (s, e) in spans.items()}
        out["other"] = (end - min(s for s, _ in spans.values())
                        - sum(out.values()))
        return out


SETUP = SetupTimers()


def process_start() -> Optional[float]:
    """The process's start on the ``time.perf_counter`` clock, to the
    kernel's 10-ms tick: ``/proc/self/stat``'s field 22 (ticks after boot)
    against ``CLOCK_BOOTTIME``; None without ``/proc``."""
    try:
        with open("/proc/self/stat", "rb") as f:
            stat = f.read()
        # the fields after the command's ')' start at field 3
        ticks = int(stat[stat.rindex(b")") + 2:].split()[19])
        boot = time.clock_gettime(time.CLOCK_BOOTTIME)
        hz = os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, AttributeError):
        return None
    now = time.perf_counter()
    return now - (boot - ticks / hz)


def note_import(first_line: float) -> None:
    """Record set-up's 'before_program' (where ``/proc`` gives the
    process's start) and 'import' phases, the package's first line at
    ``first_line``; called at the end of ``ttrt_torch.app``'s body."""
    start = process_start()
    if start is not None:
        SETUP.mark("before_program", start, first_line)
    SETUP.mark("import", first_line)


def touch_device(device) -> None:
    """Set-up's 'device' phase at the program's first touch of a device:
    for a CUDA device whose runtime torch has not started, the runtime's
    start and the context's creation (a memory query, which needs one); a
    no-op once the phase is recorded."""
    if "device" in SETUP.spans:
        return
    with SETUP.setup_span("device"):
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_initialized():
            torch.cuda.init()
            torch.cuda.mem_get_info(dev)


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
