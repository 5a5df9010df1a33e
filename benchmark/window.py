"""The measured window: the program's own loop, ``run_animation``, driven
into a sink, with every frame's write timed and every frame's inputs
recorded.

- ``FrameClock`` stands in for the program's ``StageTimers``: it keeps
  every sample of every stage (``StageTimers`` keeps 4,096), notes the
  end of each frame's 'encode+write' stage (each loop writes a frame in
  one such stage) and tells the sink where a frame's bytes begin and end.
- ``Sink`` is the loop's byte stream. It copies each frame's writes into
  one buffer of a frame's size, as a pipe's write copies into the kernel,
  and keeps nothing else, except references to the few frames the check
  decodes. When the window's time is up it raises SIGINT in its own
  process: the loop's SIGINT flag stops it after that frame.
- ``Recorder`` wraps the program's four frame-step builders, which
  ``run_animation`` and ``run_physics`` look up at call time. The step it
  returns adds the orbit's phase to the scene time (a physics step: takes
  the steps made as the scene time), notes that time and the host clock
  at the call, and returns the program's own result.
"""

from __future__ import annotations

import contextlib
import signal
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

WRITE_STAGE = "encode+write"


class FrameClock:
    """Per-stage host-clock samples (all of them), the end of each frame's
    write, and, when ``markers`` is set, a profiler range around each
    stage (read by the trace)."""

    def __init__(self, sink: "Sink", markers: bool = False):
        self.samples: Dict[str, List[float]] = defaultdict(list)
        self.written: List[float] = []
        self.sink = sink
        self.markers = markers

    @contextlib.contextmanager
    def stage(self, name: str):
        is_write = name == WRITE_STAGE
        if is_write:
            self.sink.begin_frame()
        rf = (torch.profiler.record_function(f"stage:{name}")
              if self.markers else contextlib.nullcontext())
        t0 = time.perf_counter()
        try:
            with rf:
                yield
        finally:
            t1 = time.perf_counter()
            self.samples[name].append(t1 - t0)
            if is_write:
                self.written.append(t1)
                self.sink.end_frame(t1)


class Sink:
    """The loop's byte stream: frame writes land in one preallocated
    buffer; other writes (the cursor, the fps line) are dropped.

    ``keep_after``: (offset in seconds from the end of the first frame's
    write, skip) pairs; the frame ``skip`` frames after the first that
    starts past each offset is kept for the check, as is the first frame
    itself. The skip spreads the kept frames over the places in a batch:
    the first frame past a moment is most often a batch's first.
    ``seconds``: the window's length, after which SIGINT is raised once
    (None: never). ``on_frame(i)`` is called after frame i is complete."""

    def __init__(self, frame_bytes: int, seconds: Optional[float] = None,
                 keep_after: Sequence[tuple] = (),
                 on_frame: Optional[Callable[[int], None]] = None):
        self.buf = np.empty(frame_bytes, np.uint8)
        self.seconds = seconds
        self.keep_after = sorted(keep_after)
        self.on_frame = on_frame
        self.frames = 0
        self.bad_frames: List[int] = []
        self.kept: Dict[int, List[bytes]] = {}
        self.first_end: Optional[float] = None
        self.stopped = False
        self._off = 0
        self._in_frame = False
        self._keep: Optional[List[bytes]] = None

    def begin_frame(self) -> None:
        self._in_frame = True
        self._off = 0
        self._keep = None
        keep = self.frames == 0
        if (self.keep_after and self.first_end is not None
                and time.perf_counter() - self.first_end
                >= self.keep_after[0][0]):
            offset, skip = self.keep_after[0]
            if skip == 0:
                self.keep_after.pop(0)
                keep = True
            else:
                self.keep_after[0] = (offset, skip - 1)
        if keep:
            self._keep = self.kept.setdefault(self.frames, [])

    def write(self, data) -> int:
        n = len(data)
        if not self._in_frame:
            return n
        if self._off + n <= self.buf.size:
            self.buf[self._off:self._off + n] = np.frombuffer(data, np.uint8)
        self._off += n
        if self._keep is not None:
            self._keep.append(data)
        return n

    def flush(self) -> None:
        pass

    def end_frame(self, t: float) -> None:
        self._in_frame = False
        if self._off != self.buf.size:
            self.bad_frames.append(self.frames)
        i = self.frames
        self.frames += 1
        if i == 0:
            self.first_end = t
        if self.on_frame is not None:
            self.on_frame(i)
        if (self.seconds is not None and not self.stopped
                and t - self.first_end >= self.seconds):
            self.stopped = True
            signal.raise_signal(signal.SIGINT)

    def last_frame(self) -> bytes:
        """The last frame written: the buffer's bytes."""
        return self.buf.tobytes()


class Recorder:
    """Wraps ``app.build_frame_step``, ``build_pathtrace_frame_step``,
    ``build_frame_batch_step`` and ``build_physics_frame_step`` for the
    life of a ``with`` block.

    Each call of a step is noted as (scene time, host clock at the call,
    frames it makes). ``phase`` is added to the scene time. The batched
    step's scene clock is ``scene_fps``: the loop passes it t0 = issued
    frames x the loop's frame duration (1e-9 s with pacing off, which
    would make a batch one picture), so the wrapper passes the step
    phase + issued / scene_fps, and builds it with that frame rate.

    The physics step is built with the frame rate ``scene_fps`` too, so
    that the world advances 1 / scene_fps a frame while the loop's pacing
    stays off; its k-th call since its build is noted at scene time k /
    scene_fps, the frame that shows the world after k steps. Once
    ``watch(sink)`` is called, the state each call returns is kept for
    the frames the sink keeps and for the last (``kept_states``)."""

    BUILDERS = ("build_frame_step", "build_pathtrace_frame_step",
                "build_frame_batch_step", "build_physics_frame_step")

    def __init__(self, app, phase: float, scene_fps: float,
                 loop_frame_duration: float):
        self.app = app
        self.phase = phase
        self.scene_fps = scene_fps
        self.loop_frame_duration = loop_frame_duration
        self.calls: List[tuple] = []
        self._saved = {}
        self._sink: Optional[Sink] = None
        self._states: Dict[int, object] = {}
        self._last = None

    def __enter__(self):
        for name in self.BUILDERS:
            self._saved[name] = getattr(self.app, name)
        self.app.build_frame_step = self._wrap_single("build_frame_step")
        self.app.build_pathtrace_frame_step = self._wrap_single(
            "build_pathtrace_frame_step")
        self.app.build_frame_batch_step = self._wrap_batch()
        self.app.build_physics_frame_step = self._wrap_physics()
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(self.app, name, fn)
        return False

    def _wrap_single(self, name: str):
        build = self._saved[name]

        def builder(*args, **kw):
            step = build(*args, **kw)

            def frame_step(t, cam_offset):
                t = t + self.phase
                self.calls.append((t, time.perf_counter(), 1))
                return step(t, cam_offset)

            return frame_step

        return builder

    def _wrap_batch(self):
        build = self._saved["build_frame_batch_step"]

        def builder(scene, cfg, batch, *args, **kw):
            step = build(scene, cfg.with_(frame_rate=self.scene_fps), batch,
                         *args, **kw)

            def batch_step(t0, cam_offset):
                issued = round(t0 / self.loop_frame_duration)
                t0 = self.phase + issued / self.scene_fps
                self.calls.append((t0, time.perf_counter(), batch))
                return step(t0, cam_offset)

            return batch_step

        return builder

    def _wrap_physics(self):
        build = self._saved["build_physics_frame_step"]

        def builder(scene, cfg, *args, **kw):
            step = build(scene, cfg.with_(frame_rate=self.scene_fps), *args,
                         **kw)
            taken = 0

            def frame_step(state, cam_offset, count_rays=False):
                nonlocal taken
                self._keep_last()
                taken += 1
                self.calls.append((taken / self.scene_fps,
                                   time.perf_counter(), 1))
                out = step(state, cam_offset, count_rays)
                self._last = out[0]
                return out

            return frame_step

        return builder

    def watch(self, sink: Sink) -> None:
        """Keep the physics states of the frames ``sink`` keeps, from the
        next call on."""
        self._sink, self._states, self._last = sink, {}, None

    def _keep_last(self) -> None:
        """Before a call: keep the last call's state if its frame, written
        by now, is one the sink keeps."""
        i = len(self.calls) - 1
        if (self._sink is not None and self._last is not None
                and i in self._sink.kept):
            self._states[i] = self._last

    def kept_states(self) -> Dict[int, object]:
        """The physics state of each kept frame and of the last, by the
        frame's index; empty where no physics step ran."""
        if self._last is not None:
            self._states[len(self.calls) - 1] = self._last
        return self._states

    def frames(self) -> List[tuple]:
        """(scene time, host clock at its step's call) of each frame in the
        order the loop makes them: a batch's k-th frame at t0 + k /
        scene_fps, computed in float32 as the batched step computes it."""
        out = []
        for t, called, n in self.calls:
            if n == 1:
                out.append((t, called))
                continue
            ts = torch.tensor(t, dtype=torch.float32) + torch.arange(
                n, dtype=torch.float32) * torch.tensor(1.0 / self.scene_fps,
                                                       dtype=torch.float32)
            out += [(tk, called) for tk in ts.tolist()]
        return out


def drive(app, cfg, config: dict, loop: dict, scene, seed: int, device,
          sink: Sink, clock: FrameClock,
          max_frames: Optional[int] = None) -> None:
    """One call of ``run_animation`` as the CLI makes it, non-interactive,
    into ``sink``, timed by ``clock``. A scene kind whose
    ``scenes/<kind>.py`` defines ``drive`` is driven by that instead."""
    app.run_animation(cfg, config["sky"], max_frames=max_frames,
                      interactive=False, encode=loop["encode"], scene=scene,
                      pipeline=loop["pipeline"], device=device, stream=sink,
                      timers=clock, renderer=config["renderer"],
                      pathtrace=loop["pathtrace"], seed=seed,
                      batch=loop["batch"])
