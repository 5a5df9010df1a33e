"""CLI application: the animated frame loop and still rendering of the demo
scene and the many-object scene, by ray tracing or by Monte-Carlo path
tracing (port of ``ttrt.app``).

Reference driver: main (TerminalRayTracer.c:1235-1370). Per tick:

    host clock t -> frame_step(t, cam_offset), all on the device:
        orbit camera pose
        render (a CUDA kernel, or the eager integrator or path tracer; the
            kernel's plain version with --device cpu)
        quantize, and ANSI-encode on the device (--encode device) or keep
            the compact (H, W, 3) uint8 frame (--encode host)
    -> one device->host uint8 copy -> the host's ANSI expansion (the native
       C encoder, ``native``) -> one write(2) -> pace -> fps HUD

On the card a kernel's frame step is captured once into a CUDA graph and
replayed on every later frame (``step_graph``): one host call a frame in
place of the pose's, the pack's and the quantize's ops one by one.

``--encode auto``, the default, is 'host' when the native library is
available, else 'device'.

Scene state is a pure function of t, so a run is resumed by its t. The
physics tier (``--scene physics``) steps its sphere world each frame
instead; its state is saved to and resumed from ``--checkpoint``.

``--mesh`` renders each frame over a device mesh of ranks
(``parallel``): every rank runs this loop's frame step on its share of
the frame, rank 0 picks each frame's time and camera offset and
broadcasts them, and rank 0 alone encodes and writes the frame.

``--batch N`` renders N consecutive frames (t0 + k/fps) per step into one
(N, H, W, 3) uint8 tensor and copies it to the host in one copy, several
batches in flight; the host expands and paces each frame, with scene time
following the frame index. ``--batch 0`` (the default) means 1: the JAX
package picks 8 on an accelerator to amortize a remote host link, and the
port's card is local. ``--mesh`` forces batch 1 and ``--pathtrace`` never
batches, as in JAX.

``--debug-nans`` checks each frame's float framebuffer before it is
quantized and raises ``FloatingPointError`` on the first one that is not
finite; off, it costs nothing.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import contextlib
import functools
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from ttrt_torch import IMPORTED_AT, assets, native, step_graph
from ttrt_torch.config import ConfigError, RenderConfig
from ttrt_torch.frames import orbit_camera_frame
from ttrt_torch.kernels import mesh_fused, pathtrace, render
from ttrt_torch.mesh.scene import MeshScene, many_sphere_scene
from ttrt_torch.parallel import mesh as pmesh
from ttrt_torch.parallel import objects, sharding
from ttrt_torch.physics.demo import (build_physics_demo,
                                     build_physics_frame_step,
                                     load_checkpoint, save_checkpoint)
from ttrt_torch.render import integrator
from ttrt_torch.render import pathtrace as estimator
from ttrt_torch.scene import Scene, demo_scene
from ttrt_torch.scenefile import SceneFileError, load_scene_file
from ttrt_torch.term.display import (KeyboardInput, SigintFlag,
                                     TerminalDisplay, print_ppm)
from ttrt_torch.term.encoder import (ansi_template, encode_ansi_frame,
                                     encode_ansi_host, encode_rgb_frame)
from ttrt_torch.utils.logging import log
from ttrt_torch.utils.profiling import (SETUP, StageTimers, note_import,
                                        profile_trace, recording, span,
                                        touch_device)

CAMERA_MOVE_SPEED = 0.1  # meters per keypress (reference stub's constant)
_KEY_MOVES = {"up": (1, 1.0), "down": (1, -1.0), "left": (0, -1.0),
              "right": (0, 1.0)}


RENDERERS = ("auto", "kernel", "eager")


def _pick_renderer(scene, cfg: RenderConfig, renderer: str = "auto"):
    """The render path (``ttrt.app._pick_renderer``, app.py:190-220):

    - ``eager``, or ``auto`` in float64: the eager integrator
      (``render.integrator.render_frame``), the only path for ``--f64``;
    - otherwise a kernel: the demo scene's ``render_frame``, or for a
      ``MeshScene`` with a cluster pack the fused whole-frame kernel
      (each the CUDA kernel for CUDA tensors, its plain version for CPU
      tensors). A config no kernel serves is refused here, before the
      first frame (``kernel`` asks for a kernel explicitly).

    The integrator traces a ``MeshScene`` on the card through the float32
    ``cluster_nearest`` kernel, so a float64 ``MeshScene`` runs on the CPU
    only (the JAX package traces it in float32 on an accelerator)."""
    if renderer not in RENDERERS:
        raise ConfigError(f"unknown renderer {renderer!r}")
    if renderer == "eager" or (renderer == "auto"
                               and cfg.dtype != torch.float32):
        _check_f64_mesh_on_cpu(scene, cfg)
        return integrator.render_frame
    if isinstance(scene, MeshScene):
        mesh_fused.check_supported(scene, cfg)
        return mesh_fused.render_frame_mesh_fused
    render.check_supported(scene, cfg)
    return render.render_frame


def _pick_renderer_sharded(scene, cfg: RenderConfig, mesh,
                           renderer: str = "auto"):
    """The multi-device analog of ``_pick_renderer``
    (``ttrt.app._pick_renderer_sharded``, app.py:223-266): a (scene, cfg,
    count_rays=...) -> (fb, rays) function over ``mesh``, with the same
    routing.

    - an objects axis: the eager integrator with the geometry sharded
      (``parallel.objects``); it needs a cluster-packed ``MeshScene``;
    - ``eager``, or ``auto`` in float64: the sharded eager integrator;
    - otherwise the band launches of a kernel: the fused kernel for a
      ``MeshScene``, the demo kernel for the demo scene.

    Height and spp must divide by the mesh's rows and samples."""
    if renderer not in RENDERERS:
        raise ConfigError(f"unknown renderer {renderer!r}")
    sharding.check_mesh_divisible(cfg, mesh)
    if pmesh.OBJECTS in mesh.mesh_dim_names:
        if not (isinstance(scene, MeshScene)
                and scene.clusters is not None):
            raise ConfigError(
                "--mesh with an objects factor needs a cluster-packed "
                "many-object scene (--scene many)")
        if cfg.dtype != torch.float32:
            raise ConfigError("--mesh with an objects factor traces "
                              "through the float32 cluster_nearest: --f64 "
                              "is refused with it")
        return functools.partial(objects.render_frame_sharded_objects,
                                 mesh=mesh)
    if renderer == "eager" or (renderer == "auto"
                               and cfg.dtype != torch.float32):
        _check_f64_mesh_on_cpu(scene, cfg)
        return functools.partial(sharding.render_frame_sharded, mesh=mesh)
    if isinstance(scene, MeshScene):
        mesh_fused.check_supported(scene, cfg)
        return functools.partial(sharding.render_frame_sharded_mesh_fused,
                                 mesh=mesh)
    render.check_supported(scene, cfg)
    return functools.partial(sharding.render_frame_sharded_kernel,
                             mesh=mesh)


def _check_f64_mesh_on_cpu(scene, cfg: RenderConfig) -> None:
    """The eager paths trace a ``MeshScene`` on the card through the
    float32 ``cluster_nearest`` kernel: float64 needs the CPU."""
    if (isinstance(scene, MeshScene) and cfg.dtype != torch.float32
            and scene.spheres.radius.device.type != "cpu"):
        raise ConfigError("--f64 with --scene many needs --device cpu: "
                          "the card traces a MeshScene through the "
                          "float32 cluster_nearest kernel")


def _pick_pathtracer(scene, lights, cfg: RenderConfig,
                     renderer: str = "auto") -> bool:
    """The ``--pathtrace`` path (``ttrt.app.build_pathtrace_frame_step``,
    app.py:73-80): True for the path-tracing kernel, False for the eager
    estimator (``render.pathtrace.pathtrace_frame``).

    - ``eager``, or ``auto`` in float64, on a ``MeshScene`` or under an
      image cubemap (the kernel is procedural-sky only, as JAX's): the
      estimator;
    - otherwise the kernel (the CUDA kernel for CUDA tensors, its plain
      version for CPU tensors). A config outside the kernel's gates is
      refused here, before the first frame, with a pointer to
      ``--renderer eager``."""
    if renderer not in RENDERERS:
        raise ConfigError(f"unknown renderer {renderer!r}")
    if renderer == "eager" or (renderer == "auto" and (
            cfg.dtype != torch.float32 or isinstance(scene, MeshScene)
            or scene.skybox.procedural is None)):
        _check_f64_mesh_on_cpu(scene, cfg)
        return False
    try:
        pathtrace.check_supported(scene, lights, cfg)
    except ConfigError as e:
        raise ConfigError(f"{e} (--renderer eager runs the Monte-Carlo "
                          "estimator)") from None
    return True


def make_scene(kind: str, cfg: RenderConfig, skybox_name: str, *, device,
               n_spheres: int = 10_000):
    """The scene of ``--scene``: the reference's demo scene, or the
    many-object scene (``n_spheres`` random spheres over a triangle-mesh
    floor, with its cluster pack), in the config's dtype."""
    touch_device(device)
    with SETUP.setup_span("scene"):
        skybox = assets.load_skybox(skybox_name, device=device)
        if kind == "many":
            return many_sphere_scene(skybox, n_spheres, cfg.width,
                                     cfg.height, dtype=cfg.dtype,
                                     device=device)
        if kind != "demo":
            raise ConfigError(f"unknown scene {kind!r}")
        return demo_scene(skybox, cfg.width, cfg.height, dtype=cfg.dtype,
                          device=device)


def _pick(scene, cfg: RenderConfig, renderer: str, mesh):
    """``_pick_renderer``, or over a ``mesh`` ``_pick_renderer_sharded``."""
    if mesh is None:
        return _pick_renderer(scene, cfg, renderer)
    return _pick_renderer_sharded(scene, cfg, mesh, renderer)


def _mesh_context(mesh_spec, scene, device):
    """(a context that yields the device mesh of ``mesh_spec``, or None
    without one; the device to render on: the scene's, else this rank's
    local ``device``)."""
    if mesh_spec is None:
        return contextlib.nullcontext(), device
    if scene is not None:
        device = scene.spheres.radius.device
    device = pmesh.local_device(device)
    return pmesh.open_mesh(mesh_spec, device), device


def resolve_encode(encode: str) -> str:
    """``--encode``: 'auto' is 'host' when the native encoder is available,
    else 'device'; 'device' and 'host' stand."""
    if encode == "auto":
        return "host" if native.available else "device"
    return encode


def host_encoder(cfg: RenderConfig):
    """(H, W, 3) uint8 -> the frame's ANSI bytes on the host: the native C
    encoder when it is available, else the NumPy one."""
    if native.available:
        return native.NativeAnsiEncoder(cfg.height, cfg.width).encode
    return encode_ansi_host


def _finite_check(debug_nans: bool):
    """(fb, t) -> None: with ``debug_nans``, raise FloatingPointError when
    the float framebuffer of scene time t holds a NaN or an infinity (one
    sync a frame); without, nothing."""
    if not debug_nans:
        return lambda fb, t: None

    def check(fb, t):
        if not bool(torch.isfinite(torch.stack(tuple(fb))).all()):
            raise FloatingPointError(
                f"--debug-nans: non-finite framebuffer at t={float(t):.6f}s")

    return check


def _encoder(cfg: RenderConfig, encode: str, device, mesh):
    """fb -> frame bytes: the ANSI buffer ('device') or the compact (H, W,
    3) uint8 frame ('host'); over a mesh, None on every rank but 0, which
    alone writes the frame."""
    if mesh is not None and dist.get_rank() != 0:
        return lambda fb: None
    if encode != "device":
        return encode_rgb_frame
    template = ansi_template(cfg.width, cfg.height, device)
    return lambda fb: encode_ansi_frame(fb, template)


def _posed(scene, cfg: RenderConfig, t: float, cam_offset: torch.Tensor,
           device):
    """``scene`` seen from the orbit camera at scene time ``t``, moved by
    ``cam_offset``."""
    frame = orbit_camera_frame(t, dtype=cfg.dtype, device=device)
    return scene.with_camera_frame(
        frame._replace(origin=frame.origin + cam_offset))


def build_frame_step(scene, cfg: RenderConfig, encode: str = "device",
                     renderer: str = "auto", mesh=None,
                     debug_nans: bool = False):
    """(t, cam_offset) -> frame bytes on the scene's device. ``cam_offset``
    is a world-frame camera translation driven by arrow keys (extension;
    reference stub at TerminalRayTracer.c:1196-1215).

    ``encode``: 'device' returns the full ANSI buffer; 'host' returns the
    compact (H, W, 3) uint8 frame, which the host expands. ``mesh`` (a
    ``parallel.mesh`` device mesh) renders the frame over its ranks
    (``_pick_renderer_sharded``); rank 0 alone gets the frame's bytes, the
    others None. ``debug_nans``: ``_finite_check``. Where
    ``step_graph.engages``, the step is a ``step_graph.GraphedStep``:
    captured on its first call, replayed after."""
    device = scene.spheres.radius.device
    render_fn = _pick(scene, cfg, renderer, mesh)
    enc = _encoder(cfg, encode, device, mesh)
    check = _finite_check(debug_nans)

    def frame_step(t, cam_offset: torch.Tensor):
        with span("pose"):
            s = _posed(scene, cfg, t, cam_offset, device)
        fb, _ = render_fn(s, cfg, count_rays=False)
        check(fb, t)
        with span("quantize"):
            return enc(fb)

    if step_graph.engages(device, render_fn, mesh, debug_nans):
        return step_graph.GraphedStep(frame_step, cfg.dtype, device)
    return step_graph.eager(frame_step, device)


def build_frame_batch_step(scene, cfg: RenderConfig, batch: int,
                           renderer: str = "auto", debug_nans: bool = False):
    """(t0, cam_offset) -> the (batch, H, W, 3) uint8 frames at scene times
    t0 + k / fps (k < batch, computed in the config's dtype as JAX's
    ``build_frame_batch_step``, app.py:302-334, computes them), rendered by
    ``_pick_renderer``'s path into one tensor on the scene's device, for
    one copy to the host. Frame k equals ``build_frame_step(...,
    'host')`` at that time, bit for bit: the times are added on the
    scene's device, and a float32 addition has the same bits everywhere.
    Graphed as ``build_frame_step`` is, with t0 the graph's input."""
    device = scene.spheres.radius.device
    render_fn = _pick_renderer(scene, cfg, renderer)
    check = _finite_check(debug_nans)
    step = (torch.arange(batch, dtype=cfg.dtype) * torch.tensor(
        cfg.frame_duration, dtype=cfg.dtype)).to(device)

    def batch_body(t0: torch.Tensor, cam_offset: torch.Tensor
                   ) -> torch.Tensor:
        out = torch.empty((batch, cfg.height, cfg.width, 3),
                          dtype=torch.uint8, device=device)
        ts = t0 + step
        for k in range(batch):
            with span("pose"):
                s = _posed(scene, cfg, ts[k], cam_offset, device)
            fb, _ = render_fn(s, cfg, count_rays=False)
            check(fb, ts[k])
            with span("quantize"):
                out[k] = encode_rgb_frame(fb)
        return out

    if step_graph.engages(device, render_fn, None, debug_nans):
        return step_graph.GraphedStep(batch_body, cfg.dtype, device)

    def batch_step(t0: float, cam_offset: torch.Tensor) -> torch.Tensor:
        return batch_body(torch.full((), t0, dtype=cfg.dtype, device=device),
                          cam_offset)

    return step_graph.eager(batch_step, device)


def _frame_generator(seed: int, device) -> torch.Generator:
    """The eager estimator's random stream: a generator on ``device``."""
    return torch.Generator(device=device).manual_seed(seed & 0xFFFFFFFF)


def build_pathtrace_frame_step(scene, cfg: RenderConfig,
                               encode: str = "device", seed: int = 0,
                               renderer: str = "auto", mesh=None,
                               debug_nans: bool = False):
    """(t, cam_offset) -> frame bytes by Monte-Carlo path tracing with the
    demo's area light (``ttrt.app.build_pathtrace_frame_step``,
    app.py:56-167). Each frame draws its own stream from ``seed`` and the
    scene time: the kernel takes the JAX app's frame seed
    (``kernels.pathtrace.frame_seed``), the eager estimator a generator
    seeded with it. Over a ``mesh`` (app.py:81-123) every rank renders the
    whole image at spp/n_devices from its own stream of that seed
    (``parallel.sharding``), through the path the single device would
    take; the mesh may have no objects axis. ``debug_nans``:
    ``_finite_check``."""
    device = scene.spheres.radius.device
    lights = estimator.default_area_lights(cfg, device)
    use_kernel = _pick_pathtracer(scene, lights, cfg, renderer)
    if mesh is not None:
        sharding.check_pathtrace_mesh(cfg, mesh)
    enc = _encoder(cfg, encode, device, mesh)
    check = _finite_check(debug_nans)

    def frame_step(t: float, cam_offset: torch.Tensor):
        with span("pose"):
            s = _posed(scene, cfg, t, cam_offset, device)
        fseed = pathtrace.frame_seed(seed, t)
        if mesh is not None and use_kernel:
            fb = sharding.pathtrace_frame_sharded_kernel(s, lights, cfg,
                                                         fseed, mesh)
        elif mesh is not None:
            fb = sharding.pathtrace_frame_sharded(s, lights, cfg, fseed,
                                                  mesh)
        elif use_kernel:
            fb, _ = pathtrace.pathtrace_frame(s, lights, cfg, fseed,
                                              count_rays=False)
        else:
            fb = estimator.pathtrace_frame(
                s, lights, cfg, _frame_generator(fseed, device))
        check(fb, t)
        with span("quantize"):
            return enc(fb)

    return step_graph.eager(frame_step, device)


class FrameSync:
    """Rank 0 of a mesh picks each frame's scene time and camera offset
    (its clock, its keyboard) and broadcasts them with a go flag; the other
    ranks render what they receive until a stop. A program over
    ``torch.distributed`` has no single controller, and ranks that read
    their own clocks would render different frames."""

    def __init__(self, device):
        self.buf = torch.zeros(5, dtype=torch.float64, device=device)

    def lead(self, t: float, cam_offset: np.ndarray) -> None:
        self.buf.copy_(torch.tensor([1.0, t, *cam_offset],
                                    dtype=torch.float64))
        dist.broadcast(self.buf, src=0)

    def stop(self) -> None:
        self.buf.zero_()
        dist.broadcast(self.buf, src=0)

    def follow(self):
        """The next (t, cam_offset) of rank 0, or None at its stop."""
        dist.broadcast(self.buf, src=0)
        go, t, *offset = self.buf.tolist()
        return (t, offset) if go else None


def _to_host(buf: torch.Tensor) -> np.ndarray:
    """The frame's bytes on the host: a wait for the buffer's stream (none
    for a CPU tensor), then the copy, each its own span."""
    with span("device_wait"):
        if buf.is_cuda:
            torch.cuda.current_stream(buf.device).synchronize()
    with span("copy"):
        return buf.cpu().numpy()


def run_animation(cfg: RenderConfig, skybox_name: str = "colors",
                  max_frames: int | None = None,
                  interactive: bool = True,
                  encode: str = "auto",
                  scene: Scene | MeshScene | None = None,
                  stats: bool = False,
                  pipeline: int = 0,
                  device="cuda",
                  stream=None,
                  timers: StageTimers | None = None,
                  renderer: str = "auto",
                  pathtrace: bool = False,
                  seed: int = 0,
                  mesh_spec: str | None = None,
                  batch: int = 0,
                  profile_dir: str | None = None,
                  debug_nans: bool = False) -> float:
    """The reference's frame loop (TerminalRayTracer.c:1315-1366): render,
    draw, pace to the frame budget, print fps. Returns the last measured
    fps.

    ``pipeline`` > 0 keeps that many frames in flight, copying them to the
    host in a small thread pool; camera input takes effect ``pipeline``
    frames later. ``stream`` is the byte sink for the frames (stdout by
    default); ``timers`` collects the per-stage times. ``scene`` defaults
    to the demo scene; ``renderer`` is ``_pick_renderer``'s, or with
    ``pathtrace`` (Monte-Carlo path tracing from ``seed``)
    ``_pick_pathtracer``'s. ``mesh_spec`` (``--mesh``) renders over a
    device mesh (``parallel.mesh.open_mesh``: the launcher's process
    group, or a one-rank group made here and torn down on return); rank 0
    runs this loop and writes the frames, the other ranks render until it
    stops and return 0.

    ``encode`` is ``resolve_encode``'s. ``batch`` > 1 renders that many
    frames a step (``_run_animation_batched``); 0 means 1, ``mesh_spec``
    forces 1 and ``pathtrace`` never batches. ``profile_dir`` writes a
    torch.profiler trace of the loop there (``profile_trace``);
    ``debug_nans`` checks every frame (``_finite_check``)."""
    touch_device(device)
    encode = resolve_encode(encode)
    if mesh_spec and batch > 1:
        log("--mesh: forcing --batch 1 (the batched loop renders on one "
            "device; --pipeline still applies)")
    if mesh_spec or batch == 0:
        batch = 1
    with profile_trace(profile_dir):
        if batch > 1 and not pathtrace:
            if scene is None:
                scene = make_scene("demo", cfg, skybox_name, device=device)
            return _run_animation_batched(
                cfg, scene, batch, max_frames, interactive, renderer, stats,
                pipeline, stream, timers, debug_nans)
        mesh_ctx, device = _mesh_context(mesh_spec, scene, device)
        with mesh_ctx as mesh:
            if scene is None:
                scene = make_scene("demo", cfg, skybox_name, device=device)
            device = scene.spheres.radius.device
            if pathtrace:
                frame_step = build_pathtrace_frame_step(
                    scene, cfg, encode, seed, renderer, mesh, debug_nans)
            else:
                frame_step = build_frame_step(scene, cfg, encode, renderer,
                                              mesh, debug_nans)
            sync = (FrameSync(device) if mesh is not None
                    and dist.get_world_size() > 1 else None)
            if sync is not None and dist.get_rank() != 0:
                while (msg := sync.follow()) is not None:
                    frame_step(msg[0], torch.as_tensor(
                        msg[1], dtype=cfg.dtype, device=device))
                return 0.0
            try:
                return _animate(cfg, frame_step, sync, max_frames,
                                interactive, encode, stats, pipeline, device,
                                stream, timers)
            finally:
                if sync is not None:
                    sync.stop()


def _animate(cfg: RenderConfig, frame_step, sync, max_frames, interactive,
             encode, stats, pipeline, device, stream, timers) -> float:
    """``run_animation``'s loop on the rank that writes the frames; with a
    ``FrameSync`` it broadcasts each frame's time and camera offset to the
    other ranks first. ``timers`` records the frame steps' spans for the
    loop's lifetime (``recording``)."""
    cam_offset = np.zeros(3, np.float64)
    offset_dev = torch.zeros(3, dtype=cfg.dtype, device=device)
    timers = timers if timers is not None else StageTimers()
    fps = 0.0
    n = 0
    start = time.monotonic()
    pace = _Pacer(cfg.frame_duration)
    host_enc = host_encoder(cfg) if encode == "host" else None
    pool = (
        concurrent.futures.ThreadPoolExecutor(max_workers=max(2, pipeline))
        if pipeline > 0 else None
    )
    pending: collections.deque = collections.deque()
    first_call = None  # the process's first frame step, until its write

    def emit(buf: np.ndarray) -> None:
        nonlocal n, first_call
        with timers.stage("encode+write"):
            if host_enc is not None:
                with span("encode"):
                    buf = host_enc(buf)
            with span("write"):
                disp.write_frame(buf)
        if first_call is not None:
            SETUP.mark("first_frame", first_call)
            first_call = None
        with timers.stage("pace"):
            pace()
        n += 1

    try:
        with recording(timers), SigintFlag() as sig, \
                TerminalDisplay(stream) as disp, KeyboardInput() as keys:
            issued = 0
            while not sig.received and (
                max_frames is None or issued < max_frames
            ):
                t0 = time.monotonic()
                if interactive:
                    key = keys.poll()
                    if key == "quit":
                        break
                    if key in _KEY_MOVES:
                        axis, sign = _KEY_MOVES[key]
                        cam_offset[axis] += sign * CAMERA_MOVE_SPEED
                        offset_dev = torch.as_tensor(
                            cam_offset, dtype=cfg.dtype, device=device)
                issued += 1
                if issued == 1:
                    first_call = SETUP.start("first_frame")
                t = t0 - start
                if sync is not None:
                    sync.lead(t, cam_offset)
                if pool is not None:
                    pending.append(pool.submit(
                        _to_host, frame_step(t, offset_dev)))
                    if len(pending) <= pipeline:
                        continue  # fill the pipeline before first emit
                    with timers.stage("render+copy"):
                        buf = pending.popleft().result()
                else:
                    with timers.stage("render+copy"):
                        buf = _to_host(frame_step(t, offset_dev))
                emit(buf)
                dt_frame = max(time.monotonic() - t0, 1e-9)
                fps = 1.0 / dt_frame
                disp.write_fps(fps)
            while pending:  # drain in-flight frames
                emit(pending.popleft().result())
    finally:
        if pool is not None:
            pool.shutdown(wait=True)
    if stats:
        timers.log_summary()
        log(f"frames: {n}  mean {_mean_fps(n, start):.2f} fps")
    return fps


def _mean_fps(frames: int, start: float) -> float:
    """Frames over the loop's time from ``start`` (``time.monotonic``)."""
    return frames / max(time.monotonic() - start, 1e-9)


class _Pacer:
    """Drift-free pacing: each call sleeps until an absolute deadline that
    advances by the frame budget (reference: a relative nanosleep,
    TerminalRayTracer.c:1350-1355), resyncing when the loop falls
    behind."""

    def __init__(self, budget: float):
        self.budget = budget
        self.deadline = None

    def __call__(self) -> None:
        now = time.monotonic()
        self.deadline = (now if self.deadline is None
                         else self.deadline) + self.budget
        if self.deadline < now:  # fell behind: resync, don't death-spiral
            self.deadline = now
        native.sleep_until(self.deadline)


def _run_animation_batched(cfg: RenderConfig, scene, batch: int,
                           max_frames, interactive, renderer, stats,
                           pipeline, stream, timers, debug_nans) -> float:
    """The batched loop (``ttrt.app._run_animation_batched``,
    app.py:422-519): ``batch`` frames a step (``build_frame_batch_step``)
    and one copy to the host, ``max(2, pipeline or 3)`` batches in flight,
    the host's ANSI expansion and pacing frame by frame. Scene time follows
    the frame index (t = n / fps), not the wall clock, so a slow copy skips
    no scene time; camera input takes effect from the next batch issued."""
    device = scene.spheres.radius.device
    batch_step = build_frame_batch_step(scene, cfg, batch, renderer,
                                        debug_nans)
    host_enc = host_encoder(cfg)
    depth = max(2, pipeline or 3)
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=depth)
    pending: collections.deque = collections.deque()
    cam_offset = np.zeros(3, np.float64)
    offset_dev = torch.zeros(3, dtype=cfg.dtype, device=device)
    timers = timers if timers is not None else StageTimers()
    pace = _Pacer(cfg.frame_duration)
    fps = 0.0
    n = 0
    issued = 0
    start = time.monotonic()
    first_call = None  # the process's first batch step, until its write
    try:
        with recording(timers), SigintFlag() as sig, \
                TerminalDisplay(stream) as disp, KeyboardInput() as keys:
            while not sig.received and (max_frames is None
                                        or n < max_frames):
                while len(pending) < depth and (
                        max_frames is None or issued < max_frames + batch):
                    if issued == 0:
                        first_call = SETUP.start("first_frame")
                    pending.append(pool.submit(
                        _to_host,
                        batch_step(issued * cfg.frame_duration, offset_dev)))
                    issued += batch
                with timers.stage("render+copy"):
                    frames = pending.popleft().result()
                for rgb in frames:
                    if sig.received or (max_frames is not None
                                        and n >= max_frames):
                        break
                    t0 = time.monotonic()
                    if interactive:
                        key = keys.poll()
                        if key == "quit":
                            sig.received = True
                            break
                        if key in _KEY_MOVES:
                            axis, sign = _KEY_MOVES[key]
                            cam_offset[axis] += sign * CAMERA_MOVE_SPEED
                            offset_dev = torch.as_tensor(
                                cam_offset, dtype=cfg.dtype, device=device)
                    with timers.stage("encode+write"):
                        with span("encode"):
                            buf = host_enc(rgb)
                        with span("write"):
                            disp.write_frame(buf)
                    if first_call is not None:
                        SETUP.mark("first_frame", first_call)
                        first_call = None
                    with timers.stage("pace"):
                        pace()
                    n += 1
                    dt_frame = max(time.monotonic() - t0, 1e-9)
                    fps = 1.0 / dt_frame
                    disp.write_fps(fps)
            # the batches issued past the last frame: their copies finish
            # inside the loop's spans, and a copy's error is raised
            for job in pending:
                job.result()
    finally:
        pool.shutdown(wait=True)
    if stats:
        timers.log_summary()
        log(f"frames: {n}  batch: {batch}  mean {_mean_fps(n, start):.2f} "
            "fps")
    return fps


def run_physics(cfg: RenderConfig, skybox_name: str = "colors",
                max_frames: int | None = None, interactive: bool = True,
                encode: str = "auto", checkpoint: str | None = None, *,
                device="cuda", stream=None,
                timers: StageTimers | None = None, renderer: str = "auto",
                stats: bool = False, debug_nans: bool = False) -> float:
    """The physics tier (``ttrt.app.run_physics``, app.py:675-753): the
    demo's spheres dropped under gravity, stepped with GJK contacts every
    frame (``physics.demo``) and rendered by ``_pick_renderer``'s path, in
    ``run_animation``'s loop. With ``checkpoint`` the state is resumed from
    that file when it exists and saved to it on exit. ``timers`` gets the
    stage 'physics' (within 'render+copy') besides the loop's. ``encode``
    and ``debug_nans`` are ``run_animation``'s. Returns the last measured
    fps."""
    encode = resolve_encode(encode)
    scene = make_scene("demo", cfg, skybox_name, device=device)
    device = scene.spheres.radius.device
    state, params = build_physics_demo(scene)
    if checkpoint:
        resumed = load_checkpoint(checkpoint, state)
        if resumed is not None:
            state = resumed
            log(f"resumed physics state at t={float(state.t):.2f}s")
    timers = timers if timers is not None else StageTimers()
    step = build_physics_frame_step(scene, cfg, params,
                                    _pick_renderer(scene, cfg, renderer),
                                    timers=timers)
    enc = _encoder(cfg, encode, device, None)
    check = _finite_check(debug_nans)

    def frame_step(t: float, cam_offset: torch.Tensor):
        nonlocal state
        state, fb, _ = step(state, cam_offset)
        check(fb, state.t)
        with span("quantize"):
            return enc(fb)

    try:
        return _animate(cfg, step_graph.eager(frame_step, device), None,
                        max_frames, interactive, encode, stats, 0, device,
                        stream, timers)
    finally:
        if checkpoint:
            save_checkpoint(checkpoint, state)
            log(f"saved physics checkpoint to {checkpoint}")


# JAX bands an eager still above this many primary rays (app.py:799-809)
AUTO_BAND_RAYS = 2_000_000


def render_still(cfg: RenderConfig, skybox_name: str, t: float,
                 out_path: str, *, device="cuda",
                 scene: Scene | MeshScene | None = None,
                 renderer: str = "auto", pathtrace: bool = False,
                 seed: int = 0, mesh_spec: str | None = None,
                 n_bands: int | None = None) -> None:
    """Render one frame at time t and write it as PPM (or PNG/JPEG/BMP by
    extension, when PIL is installed). ``scene`` defaults to the demo
    scene. With ``pathtrace`` the frame comes from the eager Monte-Carlo
    estimator seeded with ``seed``, as the JAX app's still does
    (app.py:826-830). ``mesh_spec`` renders it over a device mesh
    (app.py:774-824; the estimator's ranks each draw their own stream);
    rank 0 writes the file.

    ``n_bands`` > 1 renders the frame through the eager integrator in that
    many horizontal bands (``render_frame_tiled``), as JAX's still does;
    None bands an eager frame of more than ``AUTO_BAND_RAYS`` primary rays
    by the largest divisor of the height up to 16, and leaves a kernel's
    frame whole. A mesh and ``renderer="kernel"`` refuse bands."""
    touch_device(device)
    if renderer == "kernel" and n_bands not in (None, 1):
        raise ConfigError("--bands renders through the eager integrator; "
                          "--renderer kernel renders the whole frame (drop "
                          "--bands or use --renderer eager)")
    mesh_ctx, device = _mesh_context(mesh_spec, scene, device)
    with mesh_ctx as mesh:
        if mesh is not None and n_bands not in (None, 1):
            raise ConfigError("--bands does not compose with --mesh (the "
                              "mesh's row axis already bands the frame)")
        if scene is None:
            scene = make_scene("demo", cfg, skybox_name, device=device)
        device = scene.spheres.radius.device
        s = scene.with_camera_frame(
            orbit_camera_frame(t, dtype=cfg.dtype, device=device))
        if pathtrace:
            _check_f64_mesh_on_cpu(scene, cfg)
            lights = estimator.default_area_lights(cfg, device)
            if mesh is None:
                fb = estimator.pathtrace_frame(
                    s, lights, cfg, _frame_generator(seed, device))
            else:
                sharding.check_pathtrace_mesh(cfg, mesh)
                fb = sharding.pathtrace_frame_sharded(s, lights, cfg, seed,
                                                      mesh)
        else:
            render_fn = _pick(scene, cfg, renderer, mesh)
            if n_bands is None:
                n_bands = 1
                if (mesh is None and render_fn is integrator.render_frame
                        and cfg.n_primary_rays > AUTO_BAND_RAYS):
                    n_bands = max(d for d in range(1, 17)
                                  if cfg.height % d == 0)
            if mesh is None and n_bands > 1:
                fb, _ = integrator.render_frame_tiled(s, cfg, n_bands)
            else:
                fb, _ = render_fn(s, cfg, count_rays=False)
        if mesh is not None and dist.get_rank() != 0:
            return
    rgb = _to_host(encode_rgb_frame(fb))
    if out_path.lower().endswith((".png", ".jpg", ".jpeg", ".bmp")):
        from PIL import Image

        Image.fromarray(rgb).save(out_path)
    else:
        assets.write_ppm(out_path, rgb)
    log(f"wrote {out_path} ({cfg.width}x{cfg.height}, bands={n_bands or 1})")


def show_skybox(name: str, width: int, *, device) -> None:
    """Preview a cubemap's six faces in the terminal, the reference's
    print_ppm debug aid (``ttrt.app``'s --show-skybox, app.py:1001-1014):
    a 2x3 contact sheet of the faces, downscaled to about ``width``
    columns."""
    faces = assets.load_skybox(name, device=device).to_uint8().cpu().numpy()
    sheet = np.concatenate(
        [np.concatenate(list(faces[r * 3:(r + 1) * 3]), axis=1)
         for r in range(2)], axis=0)
    step = max(1, sheet.shape[1] // max(width, 8))
    print_ppm(sheet[::step * 2, ::step])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="ttrt_torch",
        description="Terminal ray tracer (PyTorch/CUDA port)",
    )
    p.add_argument("--width", type=int, default=480)
    p.add_argument("--height", type=int, default=280)
    p.add_argument("--spp", type=int, default=10, help="AA rays per pixel")
    p.add_argument("--bounces", type=int, default=10)
    p.add_argument("--fps", type=float, default=60.0,
                   help="target frame rate")
    p.add_argument("--skybox", default="colors",
                   help="skybox name or directory (colors, uv_checker, "
                        "milky_way, ...)")
    p.add_argument("--bilinear", action="store_true",
                   help="bilinear skybox filtering (reference roadmap item)")
    p.add_argument("--specular", action="store_true",
                   help="Blinn-Phong specular highlights (latent in the "
                        "reference: commented-out code)")
    p.add_argument("--energy-model", choices=["parity", "subtract"],
                   default="parity",
                   help="reflectivity mixing model: parity = the "
                        "reference's normalized accumulation; subtract = "
                        "its roadmap model (TerminalRayTracer.c:24-28)")
    p.add_argument("--pathtrace", action="store_true",
                   help="Monte-Carlo path tracing with a spherical area "
                        "light: soft shadows + diffuse interreflection")
    p.add_argument("--seed", type=int, default=0,
                   help="RNG seed for --pathtrace")
    p.add_argument("--frames", type=int, default=None,
                   help="stop after N frames (default: run until SIGINT/q)")
    p.add_argument("--still", metavar="OUT.ppm", default=None,
                   help="render a single still to a PPM instead of animating")
    p.add_argument("--time", type=float, default=0.0,
                   help="scene time for --still")
    p.add_argument("--bands", type=int, default=None,
                   help="--still: render through the eager integrator in N "
                        "horizontal bands (bounds memory at high "
                        "resolutions; default auto)")
    p.add_argument("--pipeline", type=int, default=0,
                   help="frames kept in flight with threaded host copies "
                        "(camera input lags by N frames; 0 = synchronous)")
    p.add_argument("--stats", action="store_true",
                   help="log per-stage timing summary to stderr on exit")
    p.add_argument("--no-input", action="store_true",
                   help="disable keyboard camera controls")
    p.add_argument("--encode", choices=["auto", "device", "host"],
                   default="auto",
                   help="ANSI encode on the device (the full escape buffer "
                        "copied to the host) or on the host (a compact RGB "
                        "copy and the native C encoder); auto, the "
                        "default, picks host when the native library is "
                        "available")
    p.add_argument("--batch", type=int, default=0,
                   help="frames rendered per step and copied to the host "
                        "in one copy (camera input lags by one batch; 0 = "
                        "1; --mesh forces 1, --pathtrace never batches)")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="write a torch.profiler trace of the animation "
                        "(CPU and CUDA activity) to DIR/trace.json")
    p.add_argument("--debug-nans", action="store_true",
                   help="check each frame's framebuffer before it is "
                        "quantized and stop on the first NaN or infinity "
                        "(FloatingPointError)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda: the CUDA kernels; cpu: their plain PyTorch "
                        "versions (tests, development)")
    p.add_argument("--scene", choices=["demo", "many", "physics"],
                   default="demo",
                   help="demo: the reference's 6-sphere scene; many: "
                        "random spheres over a triangle-mesh floor; "
                        "physics: GJK bouncing spheres")
    p.add_argument("--scene-file", metavar="JSON", default=None,
                   help="declarative JSON scene description (spheres, "
                        "ground, lights, skybox); see "
                        "ttrt_torch/scenefile.py")
    p.add_argument("--show-skybox", metavar="NAME", default=None,
                   help="preview a cubemap's six faces in the terminal and "
                        "exit")
    p.add_argument("--checkpoint", default=None,
                   help="--scene physics: state checkpoint path (resumed "
                        "on start, saved on exit)")
    p.add_argument("--n-spheres", type=int, default=10_000,
                   help="sphere count for --scene many")
    p.add_argument("--f64", action="store_true",
                   help="float64 compute through the eager integrator "
                        "(with --scene many on --device cpu only: the "
                        "card's nearest-hit kernel is float32)")
    p.add_argument("--mesh", metavar="RxS[xO]", default=None,
                   help="render over a device mesh of ranks (torchrun "
                        "--nproc-per-node R*S*O, one device a rank; without "
                        "a launcher, one rank): 'auto' (every rank on the "
                        "rows axis), ROWSxSAMPLES (e.g. 4x2: rows shard "
                        "image bands, samples shard AA rays) or "
                        "ROWSxSAMPLESxOBJECTS (e.g. 2x2x2: adds the "
                        "geometry axis for --scene many); the shape must "
                        "tile the ranks")
    p.add_argument("--renderer", choices=list(RENDERERS), default="auto",
                   help="render path: a kernel or the eager integrator "
                        "(with --pathtrace: the eager estimator); auto "
                        "picks the kernel unless --f64 (or, with "
                        "--pathtrace, --scene many or an image skybox)")
    args = p.parse_args(argv)

    if args.spp < 1 or args.width < 1 or args.height < 1 or args.bounces < 1:
        p.error("--width/--height/--spp/--bounces must be >= 1")
    if args.n_spheres < 1:
        p.error("--n-spheres must be >= 1")
    if args.batch < 0:
        p.error("--batch must be >= 0")
    # geometry must stay full float32 (the TF32 analog of the TPU's bf16
    # matmul trap); the port's 3x3 products are elementwise, and these
    # keep any later matmul or convolution honest too
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        if args.device == "cuda" and not torch.cuda.is_available():
            raise ConfigError("no CUDA device is available (--device cpu "
                              "runs the plain version)")
        cfg = RenderConfig(
            width=args.width, height=args.height, rays_per_pixel=args.spp,
            bounce_limit=args.bounces, frame_rate=args.fps,
            specular=args.specular, energy_model=args.energy_model,
            skybox_bilinear=args.bilinear,
            dtype=torch.float64 if args.f64 else torch.float32,
        )
        if args.pathtrace and cfg.energy_model != "parity":
            # the path tracer splits diffuse and mirror energy by
            # reflectivity itself; refuse the flag rather than ignore it
            raise ConfigError(
                "--energy-model subtract applies to the reflection "
                "integrator, not --pathtrace")
        return _dispatch(args, cfg)
    except (assets.AssetError, ConfigError, SceneFileError) as e:
        # user errors: one line, no traceback (the reference exits with a
        # printf the same way, TerminalRayTracer.c:320)
        print(f"ttrt_torch: error: {e}", file=sys.stderr)
        return 1


def _dispatch(args, cfg: RenderConfig) -> int:
    """The parsed command, in ``ttrt.app._dispatch``'s order
    (app.py:1000-1063): --show-skybox; a scene file, which --scene many
    replaces; --still (of that scene, else the demo); --scene physics
    (the demo's spheres, whatever the file); the animation."""
    device = (args.device if args.mesh is None
              else pmesh.local_device(args.device))
    if args.show_skybox:
        show_skybox(args.show_skybox, args.width, device=device)
        return 0
    scene = None
    if args.scene_file:
        scene = load_scene_file(args.scene_file, cfg.width, cfg.height,
                                dtype=cfg.dtype, device=device)
    if args.scene == "many":
        scene = make_scene("many", cfg, args.skybox, device=device,
                           n_spheres=args.n_spheres)
    if args.mesh and args.scene == "physics":
        raise ConfigError(
            "--mesh does not apply to --scene physics (the physics step "
            "is a single-device program; rendering tiers shard)")
    if args.still:
        render_still(cfg, args.skybox, args.time, args.still, device=device,
                     scene=scene, renderer=args.renderer,
                     pathtrace=args.pathtrace, seed=args.seed,
                     mesh_spec=args.mesh, n_bands=args.bands)
        return 0
    if args.scene == "physics":
        run_physics(cfg, args.skybox, args.frames,
                    interactive=not args.no_input, encode=args.encode,
                    checkpoint=args.checkpoint, device=device,
                    renderer=args.renderer, stats=args.stats,
                    debug_nans=args.debug_nans)
        return 0
    run_animation(cfg, args.skybox, args.frames,
                  interactive=not args.no_input, encode=args.encode,
                  scene=scene, stats=args.stats, pipeline=args.pipeline,
                  device=device, renderer=args.renderer,
                  pathtrace=args.pathtrace, seed=args.seed,
                  mesh_spec=args.mesh, batch=args.batch,
                  profile_dir=args.profile, debug_nans=args.debug_nans)
    return 0


note_import(IMPORTED_AT)

if __name__ == "__main__":
    sys.exit(main())
