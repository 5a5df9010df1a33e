"""One run of one cell: set-up, the measured window, the end-to-end
metrics, the check of the frames the window wrote against the reference,
and with ``trace`` the per-layer metrics.

Set-up imports the program, builds the cell's scene, and warms its own
frame step through ``run_animation`` (the kernel library is built there
on a checkout's first run; a physics cell: through ``run_physics``,
``scenes/physics.py::drive``). The window is one more such call,
measured from the end of its first frame's write until the first write
that ends ``seconds`` later:

- ``fps``: the frames after the first over that span, and
  ``frame_ms_mean`` its inverse in ms (where the cell reports it);
- ``frame_ms_p95``: the 95th percentile of the intervals between
  consecutive writes' ends;
- ``latency_ms_p95``: the 95th percentile, over every frame, of the time
  from the call of the step that made the frame to the end of its write;
- ``setup_s``: from the harness's first statement to the end of the
  window's first write.

The check runs after the window has closed, the peak memory has been
read and the program's scene is freed.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import math
import subprocess
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from benchmark import cells, window
from benchmark.reference import ansi
from benchmark.trace import Record, Tracer, breakdown, warm_profiler

BANNED = ("jax", "jaxlib", "flax", "ttrt")
DTYPES = {"float32": torch.float32}


def banned_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's, its
    libraries' or the JAX package's."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in BANNED)


def seed_stream(seed: int, purpose: int) -> np.random.Generator:
    """An independent NumPy stream of ``seed`` for one purpose."""
    return np.random.default_rng([seed % (1 << 63), purpose])


def _metric_reader(name: str):
    path = cells.HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def power_limit_w() -> Optional[float]:
    """The card's power limit in W from nvidia-smi, None without one."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30, check=True).stdout.split()
        return float(out[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


# the numbers compared on each checked frame, program against reference,
# and the worst of each over the frames against the workload's limit
FAR_LEVELS = 8
LIMITED = ("mean_abs_diff", "far_px_pct")
WORST = {"mean_abs_diff": 255.0, "far_px_pct": 100.0, "diff_px_pct": 100.0}


def frame_numbers(got: np.ndarray, want: np.ndarray) -> dict:
    """Of two (rows, W, 3) u8 frames: the mean absolute difference of the
    channels in u8 levels; the share (%) of pixels with a channel more
    than FAR_LEVELS apart; the share (%) of pixels that differ at all."""
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    px = d.max(-1)
    return {"mean_abs_diff": float(d.mean()),
            "far_px_pct": 100.0 * float(np.mean(px > FAR_LEVELS)),
            "diff_px_pct": 100.0 * float(np.mean(px > 0))}


def log(msg: str) -> None:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)


def percentile(values, q: float) -> float:
    return float(np.percentile(np.asarray(values, np.float64), q))


def reference(cell: dict, device, dtype=torch.float32):
    """(scene, sky, render function) of the reference for ``cell`` in
    ``dtype``, each found by name: ``reference/<kind>.py``,
    ``reference/sky_<sky>.py``, and the kind's own ``render`` where it
    has one (``physics``), else ``reference/pathtrace.py`` or
    ``reference/raytrace.py`` by the loop's renderer."""
    c = cell["config"]
    kind = importlib.import_module(f"benchmark.reference.{c['kind']}")
    sky = importlib.import_module(f"benchmark.reference.sky_{c['sky']}")
    render = getattr(kind, "render", None)
    if render is None:
        renderer = ("pathtrace" if cell["workload"]["loop"]["pathtrace"]
                    else "raytrace")
        render = importlib.import_module(
            f"benchmark.reference.{renderer}").render
    return (kind.build(c, dtype=dtype, device=device),
            sky.build(c, device=device), render)


def render_reference(ref, config: dict, t: float, seed: int, rows, dtype,
                     device):
    """(the reference's u8 pixels of ``rows`` of the frame at scene time
    ``t``, on ``device``, its work count)."""
    scene, sky, render = ref
    return render(scene, sky, config, t, seed, rows, dtype=dtype,
                  device=device)


class Run:
    """A cell's run: ``run()`` fills ``line`` (the result) and ``checked``
    (name, value, limit) of every number compared."""

    def __init__(self, name: str, seed: int, seconds: float, trace: bool, *,
                 device="cuda", t_start: Optional[float] = None,
                 overrides: Optional[dict] = None,
                 spec: Optional[dict] = None):
        self.cell = cells.load_cell(name, spec, overrides)
        self.name, self.seed, self.seconds = name, seed, seconds
        self.trace, self.device = trace, torch.device(device)
        self.t_start = time.perf_counter() if t_start is None else t_start
        self.config = self.cell["config"]
        self.workload = self.cell["workload"]
        self.loop = self.workload["loop"]
        self.checked: List[tuple] = []
        self.compared: List[dict] = []  # each checked frame's pixels
        # (frame, bit for bit, largest |d|) of each checked frame's
        # program state against the reference's (physics cells)
        self.state_gaps: List[tuple] = []
        self.line: dict = {}

    # -- the program --------------------------------------------------

    def _render_config(self):
        from ttrt_torch.config import RenderConfig

        c = self.config
        return RenderConfig(width=c["width"], height=c["height"],
                            rays_per_pixel=c["spp"], bounce_limit=c["bounces"],
                            skybox_bilinear=c["bilinear"],
                            dtype=DTYPES[c["dtype"]], frame_rate=1e9)

    def _window(self):
        """Set-up and the measured window; returns the recorded frames."""
        from ttrt_torch import app

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        w, c = self.workload, self.config
        cfg = self._render_config()
        scenes = importlib.import_module(f"benchmark.scenes.{c['kind']}")
        scene = scenes.build(c, cfg, self.device)
        drive = getattr(scenes, "drive", window.drive)
        lo, hi = w["camera"]["phase_s"]
        phase = float(seed_stream(self.seed, 1).uniform(lo, hi))
        draw = seed_stream(self.seed, 2)
        n = w["check"]["frames"]
        keep = sorted(zip((draw.uniform(0.05, 0.9, n) * self.seconds).tolist(),
                          draw.integers(0, 8, n).tolist()))
        frame_bytes = ansi.frame_size(c["width"], c["height"])
        rec = window.Recorder(app, phase, w["camera"]["scene_fps"],
                              cfg.frame_duration)
        self.tracer = (Tracer(w["profile"]["skip"], w["profile"]["frames"])
                       if self.trace else None)
        if self.trace:
            warm_profiler(self.device)
        with rec:
            warm = window.Sink(frame_bytes)
            drive(app, cfg, c, self.loop, scene, self.seed, self.device,
                  warm, window.FrameClock(warm),
                  max_frames=w["warmup_frames"])
            self._sync()
            rec.calls.clear()
            self.sink = window.Sink(
                frame_bytes, self.seconds, keep,
                self.tracer.on_frame if self.tracer else None)
            rec.watch(self.sink)
            self.clock = window.FrameClock(self.sink, markers=self.trace)
            drive(app, cfg, c, self.loop, scene, self.seed, self.device,
                  self.sink, self.clock)
            self._sync()
        self.states = rec.kept_states()
        if self.tracer:
            self.tracer.close()
            log(f"the profiler's stop and parse took "
                f"{self.tracer.read_s:.2f} s inside the window")
        self.peak = (torch.cuda.max_memory_allocated(self.device)
                     if self.device.type == "cuda" else 0)
        return rec.frames()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- the end-to-end metrics -------------------------------------------

    def _end_to_end(self, frames) -> dict:
        w = np.asarray(self.clock.written)
        called = np.asarray([f[1] for f in frames[:len(w)]])
        if len(w) < 2 or len(called) < len(w):
            raise RuntimeError(f"the window wrote {len(w)} frames for "
                               f"{len(called)} recorded steps")
        return {"fps": (len(w) - 1) / (w[-1] - w[0]),
                "frame_ms_mean": 1e3 * (w[-1] - w[0]) / (len(w) - 1),
                "frame_ms_p95": percentile(1e3 * np.diff(w), 95),
                "latency_ms_p95": percentile(1e3 * (w - called), 95),
                "setup_s": w[0] - self.t_start}

    # -- the check --------------------------------------------------------

    def reference(self, dtype=torch.float32):
        return reference(self.cell, self.device, dtype)

    def render_reference(self, ref, t: float, rows, dtype=torch.float32):
        """(the reference's pixels as a NumPy array, its work count)."""
        u8, work = render_reference(ref, self.config, t, self.seed, rows,
                                    dtype, self.device)
        return u8.cpu().numpy(), work

    def _check(self, frames) -> None:
        c, chk = self.config, self.workload["check"]
        W, H = c["width"], c["height"]
        kept = {i: b"".join(chunks) for i, chunks in self.sink.kept.items()}
        last = self.sink.frames - 1
        kept.setdefault(last, self.sink.last_frame())
        rows_rng = seed_stream(self.seed, 3)
        ref = self.reference()
        state_gap = getattr(ref[0], "state_gap", None)
        failed = 0
        for i in sorted(kept):
            rows = (None if chk["rows"] is None else
                    sorted(rows_rng.choice(H, chk["rows"], replace=False)
                           .tolist()))
            t = frames[i][0]
            want, _ = self.render_reference(ref, t, rows)
            if state_gap is not None and i in self.states:
                self.state_gaps.append((i, *state_gap(self.states[i])))
            try:
                got = ansi.decode(kept[i], W, H)
                got = got if rows is None else got[rows]
                nums = frame_numbers(got, want)
            except ansi.MalformedFrame:
                got, nums = None, dict(WORST)
            self.compared.append({"frame": i, "t": t, "rows": rows,
                                  "program": got, "reference": want, **nums})
            over = [n for n in LIMITED if nums[n] > chk["limits"][n]]
            failed += bool(over)
        bad = len(self.sink.bad_frames)
        self.checked = [(n, max(f[n] for f in self.compared),
                         chk["limits"][n]) for n in LIMITED]
        self.checked += [("bad_frames", bad, 0),
                         ("frames_checked", len(kept), 2)]
        self.failed = failed + bad
        self.correct = (failed == 0 and bad == 0 and len(kept) >= 2)

    # -- the per-layer metrics --------------------------------------------

    def _profiled_work(self, frames) -> list:
        span = self.tracer.span if self.tracer else None
        if span is None:
            return []
        ref = self.reference()
        return [self.render_reference(ref, frames[i][0], None)[1]
                for i in range(span.first_frame,
                               span.first_frame + span.frames)]

    def _per_layer(self, frames, e2e: dict) -> dict:
        span = self.tracer.span if self.tracer else None
        record = Record(self.cell, self.sink.frames, dict(self.clock.samples),
                        span, lambda: self._profiled_work(frames), e2e)
        out = {}
        for m in self.cell["per_layer"]:
            v = _metric_reader(m["name"])(record)
            if v is not None:
                out[m["name"]] = {"value": v, "unit": m["unit"]}
        return out

    # -- the run --------------------------------------------------------

    def run(self) -> dict:
        frames = self._window()
        e2e = self._end_to_end(frames)
        t_closed = time.perf_counter()
        log(f"{self.name} seed {self.seed}: window closed "
            f"{t_closed - self.t_start:.2f} s after start, "
            f"{self.sink.frames} frames, {e2e}")
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        self._check(frames)
        t_checked = time.perf_counter()
        log(f"check {t_checked - t_closed:.2f} s")
        for i, same, gap in self.state_gaps:
            log(f"state of frame {i} (t = {frames[i][0]!r}) against the "
                f"reference's: bit for bit {same}, largest |d| {gap!r}")
        last = self.states.get(self.sink.frames - 1)
        if last is not None:
            log(f"sim time of the last frame, {self.sink.frames - 1}: "
                f"{float(last.t)!r}; frames / scene fps: "
                f"{self.sink.frames / self.workload['camera']['scene_fps']!r}")
        watts = power_limit_w() if self.device.type == "cuda" else None
        if self.trace:
            metrics = self._per_layer(frames, e2e)
            log(f"per-layer metrics {time.perf_counter() - t_checked:.2f} s")
        else:
            metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                       for m in self.cell["end_to_end"]}
        on_card = self.device.type == "cuda"
        device = {"platform": "gpu" if on_card else "cpu",
                  "kind": (torch.cuda.get_device_name(self.device)
                           if on_card else "cpu"),
                  "count": 1, "memory_peak_bytes": int(self.peak)}
        line = {"correct": bool(self.correct),
                "attempted": int(self.sink.frames),
                "failed": int(self.failed), "metrics": metrics,
                "device": device}
        span = self.tracer.span if self.tracer else None
        if span is not None:
            device["busy_s"] = span.busy_seconds()
            device["window_s"] = span.seconds
            line["breakdown"] = breakdown(span)
        line["power_limit_w"] = watts
        line["check"] = {n: {"value": v, "limit": lim}
                         for n, v, lim in self.checked}
        self.line = line
        return line


def check_lines(checked) -> List[str]:
    """The numbers compared, each beside its limit, for standard error."""
    return [f"check {n} {v!r} limit {lim!r}" for n, v, lim in checked]


def finite(line: dict) -> bool:
    return all(math.isfinite(m["value"]) for m in line["metrics"].values())


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             **kw) -> Run:
    r = Run(name, seed, seconds, trace, **kw)
    r.run()
    return r


