"""The port's bench: ray throughput, terminal streaming fps and every other
tier of the JAX package's ``bench.py``, measured on one NVIDIA GPU.

Run from the repository root:  python -m ttrt_torch.bench

It prints ONE JSON line on stdout and logs to stderr. It exits 0, or 1
when there is no CUDA device, a tier raised (the line then carries
``<tier>_error`` and the other tiers still run) or a key of ``LINE_KEYS``
is missing or not a finite number > 0.

Timing is for a local card:

  - every measurement warms up first; the first call of the rays tier
    includes the kernels' nvcc build (``compile_s``, with ``kernel_build``
    'cold' or 'warm': whether ``ttrt_torch/_build/`` already held the
    library);
  - a run is one pass of the frame step over a fixed camera window,
    between two ``torch.cuda.synchronize()`` on the host clock; the
    device-only rate (``fps_480x280_kernel_encode``) is CUDA events, and
    each kernel's own time torch.profiler's (``*_kernel_ms``, with
    ``*_kernel_ms_timed_by`` saying how it was taken);
  - the timed step is the one the app runs (``count_rays=False``); the
    numerator, the traces the kernels count, comes from an untimed pass
    over the same window with ``count_rays=True``. Trace counts depend on
    t alone and every run of a tier re-times the same window, so the
    spread of a ``*_runs`` list is timing noise;
  - a rate is the median of the per-run rates (each run over its own
    numerator): HEADLINE_RUNS runs for the headline tiers, OTHER_RUNS for
    the rest, every run in the rate's ``*_runs`` (or, one run a window,
    ``*_windows``) list; the line's ``median_of`` counts those lists;
  - a loop's fps is its steady state: the frames after the first over the
    span of their writes (``FrameClock``), with the time from the call to
    the first frame's write beside it (``*_to_first_ms``).

The key names are those of the default sizes; each tier function takes
its device, its ``RenderConfig`` and its sphere or body count as
arguments, so the tests run the same code small on the CPU.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

from ttrt_torch import app, assets
from ttrt_torch.config import RenderConfig
from ttrt_torch.frames import orbit_camera_frame
from ttrt_torch.kernels import build, mesh, mesh_fused, pathtrace, render
from ttrt_torch.mesh.scene import (MeshScene, many_sphere_scene,
                                   trace_ray_mesh_dense)
from ttrt_torch.physics.demo import (build_physics_demo,
                                     build_physics_frame_step)
from ttrt_torch.physics.world import physics_step
from ttrt_torch.render import dispatch, integrator
from ttrt_torch.render import pathtrace as estimator
from ttrt_torch.scene import Skybox, Spheres, demo_scene
from ttrt_torch.term.encoder import ansi_template, encode_ansi_frame
from ttrt_torch.utils.logging import log
from ttrt_torch.utils.profiling import StageTimers
from ttrt_torch.vec import Vec3

METRIC = "demo-scene ray throughput (480x280x10spp, 10-bounce, f32, cuda)"
HEADLINE_RUNS = 5
OTHER_RUNS = 3
DEMO = RenderConfig()  # the reference's 480x280, 10 spp, 10 bounces
MANY = RenderConfig(width=240, height=64, rays_per_pixel=2, bounce_limit=3)
PHYSICS = RenderConfig(width=240, height=64, rays_per_pixel=4,
                       bounce_limit=4)
PATHTRACE = RenderConfig(width=240, height=64, rays_per_pixel=40,
                         bounce_limit=4)
PATHTRACE_TIER = RenderConfig(width=240, height=64, rays_per_pixel=4,
                              bounce_limit=4)
STREAM_BATCH = 8
FLYOVER_SCALE = 20.0  # the exterior camera: the orbit's origin x 20
# each tier's camera window, (first scene time, step): the JAX bench's
WINDOWS = {"rays": (2.0, 0.37), "kernel_encode": (500.0, 1.0 / 60.0),
           "textured": (900.0, 0.37), "many": (1300.0, 0.21),
           "pathtrace": (1700.0, 0.41)}
# the exterior camera's windows (step 0.21), one run each
FLYOVER_BASES = {"10k": (1500.0, 1533.0, 1566.0),
                 "100k": (2100.0, 2133.0, 2166.0)}
PHYSICS_CENTERS = ("numpy default_rng(0).uniform(-3, 3, (n, 3)) as float32 "
                   "(the JAX bench draws jax.random.uniform(PRNGKey(0)))")

TIERS = ("bench_rays", "bench_streaming", "bench_textured",
         "bench_many_object", "bench_many_object_100k", "bench_physics",
         "bench_pathtrace")
_STREAM_MODES = ("device", "host", "pipelined", "batched")
TIER_KEYS = {
    "bench_rays": (
        "mrays_per_s", "mrays_per_s_runs", "rays_per_frame",
        "render_frame_ms", "compile_s", "mrays_per_s_eager",
        "mrays_per_s_eager_runs", "render_frame_ms_eager",
        "render_kernel_ms"),
    "bench_streaming": (
        *(f"fps_480x280_{m}{s}" for m in _STREAM_MODES
          for s in ("", "_runs", "_split", "_to_first_ms")),
        "fps_480x280_kernel_encode", "fps_480x280_kernel_encode_runs",
        "frame_bytes", "stream_batch"),
    "bench_textured": (
        "mrays_textured", "mrays_textured_runs", "mrays_textured_bilinear",
        "mrays_textured_bilinear_runs"),
    "bench_many_object": (
        "mrays_10k_fused", "mrays_10k_fused_runs", "mrays_10k_flyover",
        "mrays_10k_flyover_windows", "frame_ms_10k_fused",
        "frame_ms_10k_flyover", "mrays_10k_cluster", "mrays_10k_cluster_runs",
        "mrays_10k_dense_corrected", "mrays_10k_dense_corrected_runs",
        "grid_dims", "mesh_fused_kernel_ms"),
    "bench_many_object_100k": (
        "mrays_100k_flyover", "mrays_100k_flyover_windows",
        "frame_ms_100k_flyover", "subclusters_100k"),
    "bench_physics": (
        "physics_steps_per_s_64body", "physics_steps_per_s_64body_runs",
        "physics_render_fps", "physics_render_fps_runs",
        "physics_kernels_per_frame"),
    "bench_pathtrace": (
        "pathtrace_msamples_per_s", "pathtrace_msamples_per_s_runs",
        "pathtrace_msamples_tier", "pathtrace_msamples_tier_runs",
        "pathtrace_msamples_eager", "pathtrace_msamples_eager_runs",
        "pathtrace_kernel_ms"),
}
# every key the line carries, each a finite number > 0 (or a list or map
# of them)
LINE_KEYS = ("value", "power_limit_w",
             *(k for tier in TIERS for k in TIER_KEYS[tier]))
# keys measured on the card alone: a CPU run of a tier leaves them out
DEVICE_KEYS = ("render_kernel_ms", "fps_480x280_kernel_encode",
               "fps_480x280_kernel_encode_runs", "mesh_fused_kernel_ms",
               "physics_kernels_per_frame", "pathtrace_kernel_ms")
# (kernel wrapper, its plain version): the bench reports their launches
COUNTERS = ((render.render_frame_cuda, render.render_frame_plain),
            (mesh_fused.render_band_mesh_fused_cuda,
             mesh_fused.render_band_mesh_fused_plain),
            (mesh.cluster_nearest_cuda, mesh.cluster_nearest_plain),
            (pathtrace.pathtrace_frame_cuda, pathtrace.pathtrace_frame_plain))


class DenseMeshScene(MeshScene):
    """A ``MeshScene`` whose every trace, on any device, takes the dense
    tester (``mesh.scene.trace_ray_mesh_dense``)."""

    __slots__ = ()


dispatch.register_trace(DenseMeshScene, trace_ray_mesh_dense)


# ---------------------------------------------------------------------------
# Timing helpers
# ---------------------------------------------------------------------------


def _median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``reps`` launches, CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _kernel_ms(fn, name: str, reps: int = 20) -> tuple:
    """(ms, how): the mean device time of the one kernel whose name holds
    ``name`` over ``reps`` calls of ``fn``, from torch.profiler, and how it
    was measured, for the line that prints it. The profiler has come back
    without the kernel's events (the CUPTI trace is not always delivered):
    it is asked three times, then the wrapper's median by CUDA events is
    returned instead, and ``how`` says so."""
    for _ in range(3):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages() if name in e.key]
        if len(rows) == 1:
            return (rows[0].self_device_time_total / rows[0].count / 1e3,
                    f"kernel alone, torch.profiler, mean of {reps}")
    return (_median_ms(fn, reps),
            f"NOT the kernel alone: the wrapper by CUDA events, median of "
            f"{reps}, torch.profiler gave no {name} row")


def _cuda_kernels(fn) -> int | None:
    """The CUDA kernels ``fn()`` launches, from torch.profiler's device
    events less its copies and fills; None when the profiler delivers no
    device events."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = sum(1 for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.name.startswith(("Memcpy", "Memset")))
    return n or None


def _on_card(device) -> bool:
    return torch.device(device).type == "cuda"


def _sync(device) -> None:
    if _on_card(device):
        torch.cuda.synchronize(device)


def window(base: float, step: float, n: int) -> list:
    """A tier's camera window: n scene times from ``base``, ``step``
    apart (the JAX bench's bases and steps)."""
    return [base + step * k for k in range(n)]


def posed(scene, cfg: RenderConfig, t: float, scale: float = 1.0):
    """``scene`` with the orbit camera at time t, its origin scaled by
    ``scale`` (the flyover's exterior camera)."""
    frame = orbit_camera_frame(t, dtype=cfg.dtype,
                               device=scene.spheres.radius.device)
    if scale != 1.0:
        frame = frame._replace(origin=frame.origin * scale)
    return scene.with_camera_frame(frame)


def _per_frame(step, ts, runs: int, device) -> list:
    """Seconds a frame of each of ``runs`` passes of ``step(t)`` over the
    window ``ts``, each between two synchronizes (host clock), after two
    frames of warm-up."""
    for t in ts[:2]:
        step(t)
    out = []
    for _ in range(runs):
        _sync(device)
        t0 = time.perf_counter()
        for t in ts:
            step(t)
        _sync(device)
        out.append((time.perf_counter() - t0) / len(ts))
    return out


class FrameClock(StageTimers):
    """``StageTimers`` that also keep the host-clock time at which each
    'encode+write' stage ends: every loop of ``app.run_animation`` writes
    each frame in one such stage."""

    def __init__(self):
        super().__init__()
        self.written = []

    @contextlib.contextmanager
    def stage(self, name: str):
        with super().stage(name):
            yield
        if name == "encode+write":
            self.written.append(time.perf_counter())


def _mean_rays(render_fn, scene, cfg: RenderConfig, ts,
               scale: float = 1.0) -> float:
    """Mean traces a frame over the window ``ts``, from an untimed pass of
    ``render_fn(scene, cfg, count_rays=True)`` (the counts the renderer
    performs: bounces + hits x lights). Counts swing with the camera, so
    a rate's numerator is the mean over the window it timed."""
    total = 0
    for t in ts:
        _, rays = render_fn(posed(scene, cfg, t, scale), cfg,
                            count_rays=True)
        total += int(rays)
    return total / len(ts)


def _rates(run_rays, pers) -> list:
    """Mray/s of each run: its own numerator over its own time a frame."""
    return [rr / p / 1e6 for rr, p in zip(run_rays, pers)]


def _median_rate(run_rays, pers) -> float:
    """Median of the per-run Mray/s rates: each run's own numerator over
    its own time (a mean numerator over a median time would be no run's
    rate)."""
    return statistics.median(_rates(run_rays, pers))


def _window_runs(render_fn, scene, cfg, ts, runs, device,
                 scale: float = 1.0) -> tuple:
    """(traces a frame of each run, seconds a frame of each run) of
    ``render_fn`` timed over the window ``ts``: every run re-times the
    same window, so one untimed pass gives every run's numerator."""
    pers = _per_frame(lambda t: render_fn(posed(scene, cfg, t, scale), cfg,
                                          count_rays=False),
                      ts, runs, device)
    return [_mean_rays(render_fn, scene, cfg, ts, scale)] * runs, pers


def _demo(cfg: RenderConfig, device):
    """The demo scene under the procedural 'colors' sky (JAX's ``_build``)."""
    return app.make_scene("demo", cfg, "colors", device=device)


def _device_info() -> tuple:
    """(name, power limit in W) of the first card, from ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader``; raises without a
    CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available")
    row = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    name, limit = (s.strip() for s in row.rsplit(",", 1))
    return name, float(limit.split()[0])


# ---------------------------------------------------------------------------
# The tiers
# ---------------------------------------------------------------------------


def bench_rays(device="cuda", cfg: RenderConfig = DEMO, frames: int = 60,
               repeats: int = HEADLINE_RUNS, eager_frames: int = 3) -> dict:
    """Mray/s of the demo frame through the render kernel, and through the
    eager integrator (``--renderer eager``, JAX's XLA path)."""
    scene = _demo(cfg, device)
    ts = window(*WINDOWS["rays"], frames)
    cold = _on_card(device) and not build.library_path().is_file()
    t0 = time.perf_counter()
    render.render_frame(posed(scene, cfg, ts[0]), cfg, count_rays=False)
    _sync(device)
    compile_s = time.perf_counter() - t0
    rays, pers = _window_runs(render.render_frame, scene, cfg, ts, repeats,
                              device)
    rays_e, pers_e = _window_runs(integrator.render_frame, scene, cfg,
                                  ts[:eager_frames], min(repeats, OTHER_RUNS),
                                  device)
    out = {
        "mrays_per_s": _median_rate(rays, pers),
        "mrays_per_s_runs": _rates(rays, pers),
        "rays_per_frame": rays[0],
        "render_frame_ms": 1e3 * statistics.median(pers),
        "compile_s": compile_s,
        "mrays_per_s_eager": _median_rate(rays_e, pers_e),
        "mrays_per_s_eager_runs": _rates(rays_e, pers_e),
        "render_frame_ms_eager": 1e3 * statistics.median(pers_e),
    }
    if _on_card(device):
        out["kernel_build"] = "cold" if cold else "warm"
        at = posed(scene, cfg, ts[0])
        out["render_kernel_ms"], out["render_kernel_ms_timed_by"] = (
            _kernel_ms(lambda: render.render_frame(at, cfg, count_rays=False),
                       "render_kernel"))
    return out


def bench_streaming(device="cuda", cfg: RenderConfig = DEMO,
                    frames: int = 60, repeats: int = HEADLINE_RUNS,
                    batch: int = STREAM_BATCH) -> dict:
    """Steady-state fps of ``app.run_animation`` into a byte sink, pacing
    off, four ways in turns: ``--encode device``, ``--encode host`` (what
    ``auto`` picks), ``--pipeline 2`` and ``--batch 8``. A run's fps is its
    frames after the first over the span from the end of the first
    frame's write to the end of the last's (``FrameClock``), so the call's
    set-up (scene, frame step, encoder, thread pool) and what precedes the
    first write (the frames in flight; for ``--batch 8`` its first three
    batches) stay out; that lead, from the call to the end of the first
    frame's write, is ``*_to_first_ms`` (median of the runs). Each mode
    also has the ``StageTimers`` split (stage means, ms) of its median
    run. On the card also the render and on-card ANSI encode alone, CUDA
    events over the frames, with no copy and no write."""
    unpaced = cfg.with_(frame_rate=1e9)
    modes = {"device": {"encode": "device"}, "host": {"encode": "host"},
             "pipelined": {"pipeline": 2}, "batched": {"batch": batch}}

    def loop(kw, n):
        clock = FrameClock()
        _sync(device)
        t0 = time.perf_counter()
        app.run_animation(unpaced, "colors", max_frames=n, interactive=False,
                          stream=io.BytesIO(), timers=clock, device=device,
                          **kw)
        w = clock.written
        assert len(w) == n, (kw, len(w))
        return ((n - 1) / (w[-1] - w[0]),
                {name: st["mean_ms"] for name, st in clock.summary().items()},
                1e3 * (w[0] - t0))

    for kw in modes.values():
        loop(kw, 2)  # warm-up
    runs = {name: [] for name in modes}
    for _ in range(repeats):
        for name, kw in modes.items():
            runs[name].append(loop(kw, frames))
    out = {}
    for name, rs in runs.items():
        key = f"fps_480x280_{name}"
        out[key] = statistics.median(r[0] for r in rs)
        out[f"{key}_runs"] = [r[0] for r in rs]
        out[f"{key}_split"] = sorted(rs, key=lambda r: r[0])[len(rs) // 2][1]
        out[f"{key}_to_first_ms"] = statistics.median(r[2] for r in rs)

    scene = _demo(cfg, device)
    step = app.build_frame_step(scene, cfg, "device")
    zero = torch.zeros(3, dtype=cfg.dtype, device=device)
    out["frame_bytes"] = int(step(0.0, zero).numel())
    out["stream_batch"] = batch
    if _on_card(device):
        ts = window(*WINDOWS["kernel_encode"], frames)
        for t in ts[:2]:
            step(t, zero)
        fps = []
        for _ in range(repeats):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for t in ts:
                step(t, zero)
            end.record()
            end.synchronize()
            fps.append(1e3 * frames / start.elapsed_time(end))
        out["fps_480x280_kernel_encode"] = statistics.median(fps)
        out["fps_480x280_kernel_encode_runs"] = fps
    return out


def textured_scene(cfg: RenderConfig, device):
    """The demo scene with the 'colors' faces as an image cubemap (the
    procedural tag dropped): the kernel loads texels."""
    scene = _demo(cfg, device)
    return scene._replace(skybox=Skybox(scene.skybox.packed, None))


def bench_textured(device="cuda", cfg: RenderConfig = DEMO, frames: int = 60,
                   repeats: int = HEADLINE_RUNS) -> dict:
    """Mray/s of the demo frame under an image cubemap, nearest and
    bilinear."""
    scene = textured_scene(cfg, device)
    ts = window(*WINDOWS["textured"], frames)
    rays, pers = _window_runs(render.render_frame, scene, cfg, ts, repeats,
                              device)
    rays_b, pers_b = _window_runs(render.render_frame, scene,
                                  cfg.with_(skybox_bilinear=True), ts,
                                  min(repeats, OTHER_RUNS), device)
    return {"mrays_textured": _median_rate(rays, pers),
            "mrays_textured_runs": _rates(rays, pers),
            "mrays_textured_bilinear": _median_rate(rays_b, pers_b),
            "mrays_textured_bilinear_runs": _rates(rays_b, pers_b)}


def many_scene(n_spheres: int, cfg: RenderConfig, device) -> MeshScene:
    """The many-object scene of the JAX bench: ``n_spheres`` spheres over
    the triangle floor under the 'colors' faces at 64 texels as an image
    cubemap, with its grid and cluster pack."""
    sky = assets.skybox_from_faces(assets.make_colors_skybox(64),
                                   device=device)
    return many_sphere_scene(sky, n_spheres, cfg.width, cfg.height,
                             dtype=cfg.dtype, device=device)


def _flyovers(scene, cfg, bases, frames, device) -> tuple:
    """(Mray/s, ms a frame) of the fused kernel from the exterior camera,
    one run over each of the windows at ``bases``: the exterior rate
    swings with how much of the cloud is in frame, so it is pinned to
    windows spread over the orbit."""
    rates, ms = [], []
    for base in bases:
        rays, pers = _window_runs(mesh_fused.render_frame_mesh_fused, scene,
                                  cfg, window(base, 0.21, frames), 1, device,
                                  FLYOVER_SCALE)
        rates += _rates(rays, pers)
        ms += [1e3 * p for p in pers]
    return rates, ms


def bench_many_object(device="cuda", cfg: RenderConfig = MANY,
                      n_spheres: int = 10_000, frames: int = 20,
                      repeats: int = HEADLINE_RUNS,
                      eager_frames: int = 3) -> dict:
    """10k spheres over the triangle floor: the fused kernel from inside
    the cloud and from the exterior camera; the eager integrator tracing
    through ``cluster_nearest`` and through the dense tester."""
    scene = many_scene(n_spheres, cfg, device)
    fused = mesh_fused.render_frame_mesh_fused
    ts = window(*WINDOWS["many"], frames)
    rays, pers = _window_runs(fused, scene, cfg, ts, repeats, device)
    runs = min(repeats, OTHER_RUNS)
    fly, fly_ms = _flyovers(scene, cfg, FLYOVER_BASES["10k"][:runs], frames,
                            device)
    cluster = _window_runs(integrator.render_frame, scene, cfg,
                           ts[:eager_frames], runs, device)
    dense = DenseMeshScene(*scene._replace(grid=None, clusters=None))
    dense = _window_runs(integrator.render_frame, dense, cfg,
                         ts[:eager_frames], runs, device)
    out = {
        "mrays_10k_fused": _median_rate(rays, pers),
        "mrays_10k_fused_runs": _rates(rays, pers),
        "mrays_10k_flyover": statistics.median(fly),
        "mrays_10k_flyover_windows": fly,
        "frame_ms_10k_fused": 1e3 * statistics.median(pers),
        "frame_ms_10k_flyover": statistics.median(fly_ms),
        "mrays_10k_cluster": _median_rate(*cluster),
        "mrays_10k_cluster_runs": _rates(*cluster),
        "mrays_10k_dense_corrected": _median_rate(*dense),
        "mrays_10k_dense_corrected_runs": _rates(*dense),
        "grid_dims": list(scene.grid.dims),
    }
    if _on_card(device):
        at = posed(scene, cfg, ts[0])
        out["mesh_fused_kernel_ms"], out["mesh_fused_kernel_ms_timed_by"] = (
            _kernel_ms(lambda: fused(at, cfg), "mesh_fused_kernel"))
    return out


def bench_many_object_100k(device="cuda", cfg: RenderConfig = MANY,
                           n_spheres: int = 100_000, frames: int = 20,
                           repeats: int = OTHER_RUNS) -> dict:
    """100k spheres through the fused kernel from the exterior camera, one
    run over each of ``repeats`` windows (at most three)."""
    scene = many_scene(n_spheres, cfg, device)
    fly, fly_ms = _flyovers(scene, cfg,
                            FLYOVER_BASES["100k"][:min(repeats, OTHER_RUNS)],
                            frames, device)
    return {"mrays_100k_flyover": statistics.median(fly),
            "mrays_100k_flyover_windows": fly,
            "frame_ms_100k_flyover": statistics.median(fly_ms),
            "subclusters_100k": scene.clusters.kb_sph + scene.clusters.kb_tri}


def physics_world(n_bodies: int, device) -> tuple:
    """(state, params) of the JAX bench's physics world: ``n_bodies``
    spheres of radius 0.25, the first demo sphere's material, centers
    drawn uniform in [-3, 3) (PHYSICS_CENTERS), through the demo's
    ``build_physics_demo``."""
    centers = np.random.default_rng(0).uniform(
        -3.0, 3.0, (n_bodies, 3)).astype(np.float32)
    sky = assets.skybox_from_faces(assets.make_colors_skybox(8),
                                   device=device)
    base = demo_scene(sky, 16, 8, dtype=torch.float32, device=device)
    scene = base._replace(spheres=Spheres(
        center=Vec3.from_array(torch.as_tensor(centers, device=device)),
        radius=torch.full((n_bodies,), 0.25, dtype=torch.float32,
                          device=device),
        material=base.spheres.material.take(
            torch.zeros(n_bodies, dtype=torch.long, device=device))))
    return build_physics_demo(scene)


def bench_physics(device="cuda", n_bodies: int = 64, steps: int = 20,
                  cfg: RenderConfig = PHYSICS, frames: int = 10,
                  repeats: int = OTHER_RUNS) -> dict:
    """Steps a second of a ``n_bodies`` world (one substep of 1/60 s, all
    pairs through the eager GJK), timed in chains of ``steps``; fps of the
    physics demo's frame (4 substeps, the render and the on-card ANSI
    encode), in chains of ``frames``; and the CUDA kernels one such frame
    launches."""
    state, params = physics_world(n_bodies, device)

    def step(s):
        return physics_step(s, params, 1.0 / 60.0, substeps=1)

    def chains(advance, x, n):
        x = advance(advance(x))  # warm-up
        pers = []
        for _ in range(repeats):
            _sync(device)
            t0 = time.perf_counter()
            for _ in range(n):
                x = advance(x)
            _sync(device)
            pers.append((time.perf_counter() - t0) / n)
        return [1.0 / p for p in pers]

    rates = chains(step, state, steps)
    out = {"physics_steps_per_s_64body": statistics.median(rates),
           "physics_steps_per_s_64body_runs": rates,
           "physics_centers": PHYSICS_CENTERS}

    scene = _demo(cfg, device)
    pstate, pparams = build_physics_demo(scene)
    frame_step = build_physics_frame_step(scene, cfg, pparams,
                                          render.render_frame)
    template = ansi_template(cfg.width, cfg.height, device)
    zero = torch.zeros(3, dtype=cfg.dtype, device=device)

    def frame(st):
        st, fb, _ = frame_step(st, zero)
        encode_ansi_frame(fb, template)
        return st

    rates = chains(frame, pstate, frames)
    out["physics_render_fps"] = statistics.median(rates)
    out["physics_render_fps_runs"] = rates
    if _on_card(device):
        for _ in range(3):  # the profiler does not always deliver events
            n = _cuda_kernels(lambda: frame(pstate))
            if n is not None:
                out["physics_kernels_per_frame"] = n
                break
    return out


def bench_seed(t: float) -> int:
    """The JAX bench's path-tracing seed of scene time t:
    int32(float32(t) * 997)."""
    return int(np.float32(t) * np.float32(997.0))


def pathtrace_step(scene, lights, cfg: RenderConfig):
    """t -> the path-tracing kernel's frame at scene time t, seeded with
    ``bench_seed(t)``."""
    def step(t):
        fb, _ = pathtrace.pathtrace_frame(posed(scene, cfg, t), lights, cfg,
                                          bench_seed(t), count_rays=False)
        return fb

    return step


def bench_pathtrace(device="cuda", cfg: RenderConfig = PATHTRACE,
                    tier_cfg: RenderConfig = PATHTRACE_TIER,
                    frames: int = 100, eager_frames: int = 3,
                    repeats: int = HEADLINE_RUNS) -> dict:
    """Msample/s of the path-tracing kernel with the demo's area light, at
    a saturating sample count (40 spp) and at the 4-spp streaming shape;
    the eager estimator at the streaming shape. A sample is a primary
    ray."""
    lights = estimator.default_area_lights(cfg, device)
    ts = window(*WINDOWS["pathtrace"], frames)
    sat = pathtrace_step(_demo(cfg, device), lights, cfg)
    pers = _per_frame(sat, ts, repeats, device)
    runs = min(repeats, OTHER_RUNS)
    scene = _demo(tier_cfg, device)
    pers_t = _per_frame(pathtrace_step(scene, lights, tier_cfg), ts, runs,
                        device)

    def eager(t):
        gen = torch.Generator(device=device).manual_seed(
            bench_seed(t) & 0xFFFFFFFF)
        return estimator.pathtrace_frame(posed(scene, tier_cfg, t), lights,
                                         tier_cfg, gen)

    pers_e = _per_frame(eager, ts[:eager_frames], runs, device)
    out = {}
    for key, n, ps in (
            ("pathtrace_msamples_per_s", cfg.n_primary_rays, pers),
            ("pathtrace_msamples_tier", tier_cfg.n_primary_rays, pers_t),
            ("pathtrace_msamples_eager", tier_cfg.n_primary_rays, pers_e)):
        out[key] = _median_rate([n] * len(ps), ps)
        out[f"{key}_runs"] = _rates([n] * len(ps), ps)
    if _on_card(device):
        out["pathtrace_kernel_ms"], out["pathtrace_kernel_ms_timed_by"] = (
            _kernel_ms(lambda: sat(ts[0]), "pathtrace_kernel"))
    return out


# ---------------------------------------------------------------------------
# The line
# ---------------------------------------------------------------------------


def _good(v) -> bool:
    """A finite number > 0, or a non-empty list or map of them."""
    if isinstance(v, (list, dict)):
        vals = list(v.values()) if isinstance(v, dict) else v
        return bool(vals) and all(_good(x) for x in vals)
    return (isinstance(v, (int, float)) and not isinstance(v, bool)
            and math.isfinite(v) and v > 0)


def bad_keys(line: dict, keys=LINE_KEYS) -> list:
    """The keys of ``keys`` that ``line`` lacks or that hold anything but
    a finite number > 0 (or a list or map of them)."""
    return [k for k in keys if not _good(line.get(k))]


def median_of(line: dict) -> dict:
    """How many runs (or windows) each rate of ``line`` is the median of:
    the length of its ``*_runs`` or ``*_windows`` list."""
    return {k.rsplit("_", 1)[0]: len(v) for k, v in line.items()
            if k.endswith(("_runs", "_windows")) and isinstance(v, list)}


def run(repeats: int = HEADLINE_RUNS) -> tuple:
    """Every tier on the card, each with ``repeats`` runs for its headline
    rates and at most OTHER_RUNS for the rest: (the line, whether anything
    failed). The launch counters of ``COUNTERS`` are set to 0 first and
    read into the line's ``launches`` last. Raises without a card."""
    name, watts = _device_info()
    for pair in COUNTERS:
        for fn in pair:
            fn.launches = 0
    line = {"metric": METRIC, "value": 0.0, "unit": "Mray/s",
            "device": name, "power_limit_w": watts}
    failed = False
    this = sys.modules[__name__]
    for tier in TIERS:
        t0 = time.perf_counter()
        log(f"bench: {tier} ...")
        try:
            line.update(getattr(this, tier)(repeats=repeats))
            log(f"bench: {tier} done in {time.perf_counter() - t0:.1f} s")
        except Exception as e:  # a failed tier must not cost the others
            log(f"bench: {tier} FAILED after {time.perf_counter() - t0:.1f} "
                f"s:\n{traceback.format_exc()}", level="ERROR")
            line[f"{tier}_error"] = f"{type(e).__name__}: {e}"[:300]
            failed = True
    line["value"] = line.get("mrays_per_s", 0.0)
    line["median_of"] = median_of(line)
    line["launches"] = {fn.__name__: fn.launches
                        for pair in COUNTERS for fn in pair}
    bad = bad_keys(line)
    if bad:
        log(f"bench: missing or not a finite number > 0: {bad}",
            level="ERROR")
    return line, failed or bool(bad)


def main() -> int:
    try:
        line, failed = run()
    except (RuntimeError, OSError, subprocess.SubprocessError, ValueError,
            IndexError) as e:  # _device_info: no card, or no nvidia-smi
        print(json.dumps({"metric": METRIC, "value": 0.0, "unit": "Mray/s",
                          "error": f"{e} - no measurement taken"}))
        return 1
    print(json.dumps(line))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
