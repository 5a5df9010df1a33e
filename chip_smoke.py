"""Smoke run of the PyTorch/CUDA port (ttrt_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, each followed by torch.cuda.synchronize(); any failure raises and
exits non-zero:

  0. a CUDA device must be present; print the card's name and power limit;
     TF32 off.
  1. build the render kernel from this checkout's sources (nvcc).
  2. kernel vs its plain PyTorch version, both on the card, at the demo's
     full config (480x280, 10 spp, 10 bounces): the 'colors' sky at
     t = 0.0, 1.5, 7.3, plus one frame each with 'uv_checker', --specular
     and --energy-model subtract. Bar: u8 flips on <= 1% of pixels, median
     |d| < 2e-5, max |d| < 0.5/255 off the flipped pixels, trace counts
     within max(0.5%, 16).
  3. kernel vs the JAX oracle stored in tests/data/torch_port_golden.npz:
     zero u8 flips outside the stored knife-edge classes K1 | K2 and the
     quantization class KQ (tests/knife_util.py's bar).
  4. timing with CUDA events (median of 20 after warm-up): the kernel's
     wrapper (scene packing included) and the plain version at the full
     config, the device ANSI encode, the copy to the host and the write;
     the kernel's own device time from torch.profiler.
  5. 60 frames of ttrt_torch.app.run_animation into a byte sink, pacing
     off: the ANSI stream is validated, the kernel's launch count must rise
     by 60 and the plain version's must not move.

Prints, before the last line, one JSON line of the kernels' numbers; the
last line is {"ok": true, "device": {...}}. Without a CUDA device, or run
outside a checkout of the repository, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import io
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(REPO, "tests", "data", "torch_port_golden.npz")
KNIFE_CAP = 0.20  # K1 | K2 share of pixels (tests/test_pallas_kernel.py)
N_FRAMES = 60


def quantize_u8(img) -> np.ndarray:
    """The reference's output quantization: (int)(c*255) truncation."""
    return np.clip((np.asarray(img, np.float64) * 255).astype(np.int32), 0,
                   255)


def _rays_close(rays_ref: int, rays: int) -> bool:
    return abs(int(rays_ref) - int(rays)) <= max(0.005 * int(rays_ref), 16)


def plain_bar(ref: np.ndarray, out: np.ndarray, rays_ref, rays) -> dict:
    """The kernel against its plain version on the same inputs: (H, W, 3)
    float arrays. The two run the same float operations, so they differ
    only where the plain version's float64 emulation of fmaf rounds a tie
    twice or a library routine (powf) differs in its last bit."""
    ref = np.asarray(ref, np.float64)
    out = np.asarray(out, np.float64)
    d = np.abs(ref - out)
    flipped = (quantize_u8(ref) != quantize_u8(out)).any(axis=-1)
    stats = {
        "flip_px": float(flipped.mean()),
        "median_abs": float(np.median(d)),
        "max_abs": float(d.max()),
        "max_abs_unflipped": float(d[~flipped].max()) if (~flipped).any()
        else 0.0,
        "rays": int(rays), "rays_ref": int(rays_ref),
    }
    assert stats["flip_px"] <= 0.01, stats
    assert stats["median_abs"] < 2e-5, stats
    assert stats["max_abs_unflipped"] < 0.5 / 255, stats
    assert _rays_close(rays_ref, rays), stats
    return stats


def golden_bar(ref, out, k1, k2, rays_ref, rays) -> dict:
    """tests/knife_util.py::assert_quantized_exact_off_knife with the
    oracle's knife masks read from the golden file: zero quantized flips
    outside K1 | K2 | KQ, a sparse enumeration, sub-quantum agreement off
    the knife set and matched trace accounting."""
    ref = np.asarray(ref, np.float64)
    out = np.asarray(out, np.float64)
    flips = quantize_u8(out) != quantize_u8(ref)
    knife = k1 | k2
    boundary = np.abs(ref * 255 - np.round(ref * 255))
    kq = (boundary < 0.05) & (np.abs(ref - out) * 255 < 0.05)
    uncovered = flips & ~knife[..., None] & ~kq
    d = np.abs(ref - out)
    stats = {
        "uncovered": int(uncovered.sum()),
        "flip_px": int(flips.any(axis=-1).sum()),
        "knife_share": float(knife.mean()),
        "max_abs_off_knife": float(d[~knife].max()),
        "median_abs": float(np.median(d)),
        "rays": int(rays), "rays_ref": int(rays_ref),
    }
    if stats["uncovered"]:
        ys, xs, cs = np.nonzero(uncovered)
        stats["first_uncovered"] = [
            (int(y), int(x), int(c), float(ref[y, x, c]), float(out[y, x, c]))
            for y, x, c in zip(ys[:8], xs[:8], cs[:8])]
    assert stats["uncovered"] == 0, stats
    assert stats["knife_share"] <= KNIFE_CAP, stats
    assert stats["flip_px"] <= 0.03 * knife.size, stats
    assert stats["max_abs_off_knife"] < 0.5 / 255, stats
    assert stats["median_abs"] < 2e-5, stats
    assert _rays_close(rays_ref, rays), stats
    return stats


def check_golden(render, device) -> list:
    """Render every frame of the JAX golden with ``render`` (a
    ``render_frame``-like function) on ``device`` and hold it to the
    golden's bar. Returns one stats dict per frame."""
    import torch

    from ttrt_torch.config import RenderConfig
    from ttrt_torch.scene import scene_from_numpy

    g = np.load(GOLDEN)
    width, height, spp, bounces = (int(v) for v in g["config"])
    cfg = RenderConfig(width=width, height=height, rays_per_pixel=spp,
                       bounce_limit=bounces)
    out = []
    for i, t in enumerate(g["times"]):
        prefix = f"scene{i}."
        leaves = {k[len(prefix):]: g[k] for k in g.files
                  if k.startswith(prefix)}
        scene = scene_from_numpy(leaves, "colors", device=device,
                                 dtype=torch.float32)
        fb, rays = render(scene, cfg)
        stats = golden_bar(g[f"fb{i}"], fb.to_array().cpu().numpy(),
                           g[f"k1_{i}"], g[f"k2_{i}"], int(g[f"rays{i}"]),
                           int(rays))
        out.append({"t": float(t), **stats})
    return out


def validate_stream(data: bytes, width: int, height: int,
                    frames: int) -> None:
    """The ANSI stream of the animation loop: hide-cursor prefix, one
    cursor-home header per frame, frames x W x H truecolor cells, fps HUD
    lines, show-cursor trailer (.claude/skills/verify/SKILL.md)."""
    assert data.startswith(b"\x1b[?25l"), data[:16]
    headers = data.count(b"\x1b[0;0H\x1b[48;2;")
    assert headers == frames, (headers, frames)
    cells = len(re.findall(rb"\x1b\[48;2;(\d{3});(\d{3});(\d{3})m  \x1b\[0m",
                           data))
    assert cells == frames * width * height, (cells, frames * width * height)
    # one fps HUD line per frame, but for frames drained from a pipeline
    assert 1 <= data.count(b" fps\n") <= frames
    assert data.endswith(b"\x1b[0m\x1b[?25h\n"), data[-16:]


def _median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``reps`` launches, CUDA events."""
    import torch

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


def main() -> int:
    import torch

    # -- phase 0: the card ---------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    from ttrt_torch import app, assets
    from ttrt_torch.config import RenderConfig
    from ttrt_torch.frames import orbit_camera_frame
    from ttrt_torch.kernels import build
    from ttrt_torch.kernels.render import (render_frame_cuda,
                                           render_frame_plain)
    from ttrt_torch.scene import demo_scene
    from ttrt_torch.term.encoder import ansi_template, encode_ansi_frame
    from ttrt_torch.utils.profiling import StageTimers

    # -- phase 1: build ------------------------------------------------------
    t0 = time.perf_counter()
    lib_path, report = build.build()
    build.load()
    torch.cuda.synchronize()
    print(f"phase 1: built {os.path.relpath(lib_path, REPO)} in "
          f"{time.perf_counter() - t0:.2f} s")
    for line in report.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    full = RenderConfig()

    def scene_at(sky: str, t: float):
        scene = demo_scene(assets.load_skybox(sky, device=dev), full.width,
                           full.height, dtype=torch.float32, device=dev)
        return scene.with_camera_frame(
            orbit_camera_frame(t, dtype=torch.float32, device=dev))

    # -- phase 2: kernel vs plain version on the card -------------------------
    cases = [("colors", 0.0, {}), ("colors", 1.5, {}), ("colors", 7.3, {}),
             ("uv_checker", 1.5, {}), ("colors", 1.5, {"specular": True}),
             ("colors", 1.5, {"energy_model": "subtract"})]
    max_abs_err = 0.0
    for sky, t, flags in cases:
        scene = scene_at(sky, t)
        cfg = full.with_(**flags)
        fb_k, rays_k = render_frame_cuda(scene, cfg)
        fb_p, rays_p = render_frame_plain(scene, cfg)
        torch.cuda.synchronize()
        out = fb_k.to_array().cpu().numpy()
        assert out.shape == (full.height, full.width, 3)
        assert np.isfinite(out).all()
        stats = plain_bar(fb_p.to_array().cpu().numpy(), out, rays_p, rays_k)
        max_abs_err = max(max_abs_err, stats["max_abs"])
        print(f"phase 2: {sky} t={t} {flags or ''} {json.dumps(stats)}")
    torch.cuda.synchronize()

    # -- phase 3: kernel vs the stored JAX oracle ----------------------------
    for stats in check_golden(render_frame_cuda, dev):
        print(f"phase 3: golden {json.dumps(stats)}")
    torch.cuda.synchronize()

    # -- phase 4: timing -----------------------------------------------------
    scene = scene_at("colors", 1.5)
    _, rays = render_frame_cuda(scene, full)
    rays = int(rays)
    ms = _median_ms(lambda: render_frame_cuda(scene, full, count_rays=False))
    plain_ms = _median_ms(
        lambda: render_frame_plain(scene, full, count_rays=False), warmup=1)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            render_frame_cuda(scene, full, count_rays=False)
        torch.cuda.synchronize()
    (kernel_row,) = [e for e in prof.key_averages()
                     if "render_kernel" in e.key]
    kernel_device_ms = (kernel_row.self_device_time_total
                        / kernel_row.count / 1e3)
    fb, _ = render_frame_cuda(scene, full, count_rays=False)
    template = ansi_template(full.width, full.height, dev)
    encode_ms = _median_ms(lambda: encode_ansi_frame(fb, template))
    buf = encode_ansi_frame(fb, template)
    torch.cuda.synchronize()
    copy_s, write_s = [], []
    with open(os.devnull, "wb") as sink:
        for _ in range(20):
            t0 = time.perf_counter()
            host = buf.cpu().numpy()
            t1 = time.perf_counter()
            sink.write(host.tobytes())
            sink.flush()
            copy_s.append(t1 - t0)
            write_s.append(time.perf_counter() - t1)
    torch.cuda.synchronize()
    print(f"phase 4 [{card}]: 480x280x10spp, 10 bounces: kernel {ms:.4f} "
          f"ms/frame, plain version {plain_ms:.3f} ms/frame, {rays} traces "
          f"= {rays / ms / 1e3:.1f} Mray/s (kernel), "
          f"{rays / plain_ms / 1e3:.1f} Mray/s (plain); the kernel alone "
          f"{kernel_device_ms:.4f} ms of device time (torch.profiler, mean "
          f"of 20)")
    print(f"phase 4 [{card}]: ANSI encode {encode_ms:.4f} ms, copy of "
          f"{buf.numel()} bytes to the host "
          f"{1e3 * statistics.median(copy_s):.4f} ms, write "
          f"{1e3 * statistics.median(write_s):.4f} ms (medians of 20)")

    # -- phase 5: the animation loop through the kernel ----------------------
    sink = io.BytesIO()
    timers = StageTimers()
    unpaced = full.with_(frame_rate=1e9)
    render_frame_cuda.launches = 0
    render_frame_plain.launches = 0
    t0 = time.perf_counter()
    app.run_animation(unpaced, "colors", max_frames=N_FRAMES,
                      interactive=False, encode="device", device=dev,
                      stream=sink, timers=timers)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = render_frame_cuda.launches
    plain_launches = render_frame_plain.launches
    assert launches == N_FRAMES, launches
    assert plain_launches == 0, plain_launches
    validate_stream(sink.getvalue(), full.width, full.height, N_FRAMES)
    split = {name: round(st["mean_ms"], 4)
             for name, st in timers.summary().items()}
    print(f"phase 5 [{card}]: {N_FRAMES} frames in {wall:.3f} s = "
          f"{N_FRAMES / wall:.2f} fps end to end (pacing off), stage means "
          f"(ms) {json.dumps(split)}; kernel launches {launches}, plain "
          f"launches {plain_launches}")

    print(json.dumps({"kernels": [{
        "name": "render",
        "route": "cuda",
        "source": "ttrt_torch/kernels/csrc/render.cu",
        "replaces": "ttrt/kernels/render_pallas.py:894",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
