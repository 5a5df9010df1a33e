"""CLI application: the animated demo-scene frame loop and still rendering
(port of ``ttrt.app``).

Reference driver: main (TerminalRayTracer.c:1235-1370). Per tick:

    host clock t -> frame_step(t, cam_offset), all on the device:
        orbit camera pose
        render (the CUDA kernel; its plain version with --device cpu)
        quantize + ANSI-encode
    -> one device->host uint8 copy -> one write(2) -> pace -> fps HUD

Scene state is a pure function of t, so a run is resumed by its t.

One frame is rendered per step (the JAX package batches 8 frames per
device program on an accelerator, to amortize a remote host link; the port
has no such link and keeps batch 1).
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import sys
import time

import numpy as np
import torch

from ttrt_torch import assets
from ttrt_torch.config import ConfigError, RenderConfig
from ttrt_torch.frames import orbit_camera_frame
from ttrt_torch.kernels.render import check_supported, render_frame
from ttrt_torch.scene import Scene, demo_scene
from ttrt_torch.term.display import KeyboardInput, SigintFlag, TerminalDisplay
from ttrt_torch.term.encoder import (ansi_template, encode_ansi_frame,
                                     encode_ansi_host, encode_rgb_frame)
from ttrt_torch.utils.logging import log
from ttrt_torch.utils.profiling import FrameMeter, StageTimers

CAMERA_MOVE_SPEED = 0.1  # meters per keypress (reference stub's constant)
_KEY_MOVES = {"up": (1, 1.0), "down": (1, -1.0), "left": (0, -1.0),
              "right": (0, 1.0)}


def _pick_renderer(scene: Scene, cfg: RenderConfig):
    """The render path: the demo kernel's ``render_frame`` (the CUDA kernel
    for CUDA tensors, its plain version for CPU tensors). The port has no
    other path yet, so a config the kernel does not serve is refused here,
    before the first frame."""
    check_supported(scene, cfg)
    return render_frame


def build_frame_step(scene: Scene, cfg: RenderConfig,
                     encode: str = "device"):
    """(t, cam_offset) -> frame bytes on the scene's device. ``cam_offset``
    is a world-frame camera translation driven by arrow keys (extension;
    reference stub at TerminalRayTracer.c:1196-1215).

    ``encode``: 'device' returns the full ANSI buffer; 'host' returns the
    compact (H, W, 3) uint8 frame, which the host expands."""
    device = scene.spheres.radius.device
    render = _pick_renderer(scene, cfg)
    template = (ansi_template(cfg.width, cfg.height, device)
                if encode == "device" else None)

    def frame_step(t: float, cam_offset: torch.Tensor) -> torch.Tensor:
        frame = orbit_camera_frame(t, dtype=cfg.dtype, device=device)
        frame = frame._replace(origin=frame.origin + cam_offset)
        fb, _ = render(scene.with_camera_frame(frame), cfg, count_rays=False)
        if template is None:
            return encode_rgb_frame(fb)
        return encode_ansi_frame(fb, template)

    return frame_step


def _sleep_until(deadline: float) -> None:
    """Absolute-deadline sleep on the monotonic clock (drift-free pacing)."""
    delay = deadline - time.monotonic()
    if delay > 0:
        time.sleep(delay)


def _to_host(buf: torch.Tensor) -> np.ndarray:
    return buf.cpu().numpy()


def run_animation(cfg: RenderConfig, skybox_name: str = "colors",
                  max_frames: int | None = None,
                  interactive: bool = True,
                  encode: str = "device",
                  scene: Scene | None = None,
                  stats: bool = False,
                  pipeline: int = 0,
                  device="cuda",
                  stream=None,
                  timers: StageTimers | None = None) -> float:
    """The reference's frame loop (TerminalRayTracer.c:1315-1366): render,
    draw, pace to the frame budget, print fps. Returns the last measured
    fps.

    ``pipeline`` > 0 keeps that many frames in flight, copying them to the
    host in a small thread pool; camera input takes effect ``pipeline``
    frames later. ``stream`` is the byte sink for the frames (stdout by
    default); ``timers`` collects the per-stage times."""
    if scene is None:
        skybox = assets.load_skybox(skybox_name, device=device)
        scene = demo_scene(skybox, cfg.width, cfg.height, dtype=cfg.dtype,
                           device=device)
    device = scene.spheres.radius.device
    frame_step = build_frame_step(scene, cfg, encode)

    cam_offset = np.zeros(3, np.float64)
    offset_dev = torch.zeros(3, dtype=cfg.dtype, device=device)
    meter = FrameMeter()
    timers = timers if timers is not None else StageTimers()
    fps = 0.0
    n = 0
    start = time.monotonic()
    deadline = None
    pool = (
        concurrent.futures.ThreadPoolExecutor(max_workers=max(2, pipeline))
        if pipeline > 0 else None
    )
    pending: collections.deque = collections.deque()

    def emit(buf: np.ndarray) -> None:
        nonlocal deadline, n
        with timers.stage("encode+write"):
            disp.write_frame(encode_ansi_host(buf) if encode == "host"
                             else buf)
        # drift-free pacing: absolute deadlines advance by the budget
        # (reference: relative nanosleep, TerminalRayTracer.c:1350-1355)
        now = time.monotonic()
        deadline = (now if deadline is None else deadline) + cfg.frame_duration
        if deadline < now:  # fell behind: resync, don't death-spiral
            deadline = now
        with timers.stage("pace"):
            _sleep_until(deadline)
        n += 1

    try:
        with SigintFlag() as sig, TerminalDisplay(stream) as disp, \
                KeyboardInput() as keys:
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
                if pool is not None:
                    pending.append(pool.submit(
                        _to_host, frame_step(t0 - start, offset_dev)))
                    if len(pending) <= pipeline:
                        continue  # fill the pipeline before first emit
                    with timers.stage("render+copy"):
                        buf = pending.popleft().result()
                else:
                    with timers.stage("render+copy"):
                        buf = _to_host(frame_step(t0 - start, offset_dev))
                emit(buf)
                dt_frame = max(time.monotonic() - t0, 1e-9)
                fps = 1.0 / dt_frame
                meter.update(dt_frame)
                disp.write_fps(fps)
            while pending:  # drain in-flight frames
                emit(pending.popleft().result())
    finally:
        if pool is not None:
            pool.shutdown(wait=True)
    if stats:
        timers.log_summary()
        log(f"ema: {meter.hud()}  frames: {n}")
    return fps


def render_still(cfg: RenderConfig, skybox_name: str, t: float,
                 out_path: str, *, device="cuda",
                 scene: Scene | None = None) -> None:
    """Render one frame at time t and write it as PPM (or PNG/JPEG/BMP by
    extension, when PIL is installed)."""
    if scene is None:
        skybox = assets.load_skybox(skybox_name, device=device)
        scene = demo_scene(skybox, cfg.width, cfg.height, dtype=cfg.dtype,
                           device=device)
    device = scene.spheres.radius.device
    render = _pick_renderer(scene, cfg)
    frame = orbit_camera_frame(t, dtype=cfg.dtype, device=device)
    fb, _ = render(scene.with_camera_frame(frame), cfg, count_rays=False)
    rgb = _to_host(encode_rgb_frame(fb))
    if out_path.lower().endswith((".png", ".jpg", ".jpeg", ".bmp")):
        from PIL import Image

        Image.fromarray(rgb).save(out_path)
    else:
        assets.write_ppm(out_path, rgb)
    log(f"wrote {out_path} ({cfg.width}x{cfg.height})")


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
                   help="procedural skybox: colors or uv_checker")
    p.add_argument("--specular", action="store_true",
                   help="Blinn-Phong specular highlights (latent in the "
                        "reference: commented-out code)")
    p.add_argument("--energy-model", choices=["parity", "subtract"],
                   default="parity",
                   help="reflectivity mixing model: parity = the "
                        "reference's normalized accumulation; subtract = "
                        "its roadmap model (TerminalRayTracer.c:24-28)")
    p.add_argument("--frames", type=int, default=None,
                   help="stop after N frames (default: run until SIGINT/q)")
    p.add_argument("--still", metavar="OUT.ppm", default=None,
                   help="render a single still to a PPM instead of animating")
    p.add_argument("--time", type=float, default=0.0,
                   help="scene time for --still")
    p.add_argument("--pipeline", type=int, default=0,
                   help="frames kept in flight with threaded host copies "
                        "(camera input lags by N frames; 0 = synchronous)")
    p.add_argument("--stats", action="store_true",
                   help="log per-stage timing summary to stderr on exit")
    p.add_argument("--no-input", action="store_true",
                   help="disable keyboard camera controls")
    p.add_argument("--encode", choices=["device", "host"], default="device",
                   help="ANSI encode on the device (full escape buffer over "
                        "the link) or on the host (compact RGB copy)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda: the CUDA kernel; cpu: its plain PyTorch "
                        "version (tests, development)")
    args = p.parse_args(argv)

    if args.spp < 1 or args.width < 1 or args.height < 1 or args.bounces < 1:
        p.error("--width/--height/--spp/--bounces must be >= 1")
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
        )
        if args.still:
            render_still(cfg, args.skybox, args.time, args.still,
                         device=args.device)
            return 0
        run_animation(cfg, args.skybox, args.frames,
                      interactive=not args.no_input, encode=args.encode,
                      stats=args.stats, pipeline=args.pipeline,
                      device=args.device)
        return 0
    except (assets.AssetError, ConfigError) as e:
        # user errors: one line, no traceback (the reference exits with a
        # printf the same way, TerminalRayTracer.c:320)
        print(f"ttrt_torch: error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
