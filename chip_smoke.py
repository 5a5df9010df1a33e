"""Smoke run of the PyTorch/CUDA port (ttrt_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, each followed by torch.cuda.synchronize(); any failure raises and
exits non-zero:

  0. a CUDA device must be present; print the card's name and power limit;
     TF32 off.
  1. build every kernel from this checkout's sources (one nvcc process a
     source, all started together, then one link) and print each kernel's
     registers and spills.

The demo scene, through the render kernel (csrc/render.cu):

  2. kernel vs its plain PyTorch version, both on the card, at the demo's
     full config (480x280, 10 spp, 10 bounces): the 'colors' sky at
     t = 0.0, 1.5, 7.3, plus one frame each with 'uv_checker', --specular,
     --energy-model subtract and --bilinear ('uv_checker'). Bar: u8 flips
     on <= 1% of pixels, median
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

The many-object scene (10k spheres over a 512-triangle floor), through the
fused kernel and the cluster-culled nearest-hit kernel (csrc/mesh.cu):

  A. the fused kernel vs its plain version, both on the card, at 480x280,
     10 spp, 10 bounces: the 'colors' sky at t = 0.7 and 3.3 and one
     frame each with --specular, --energy-model subtract and --bilinear
     ('uv_checker'). Bar: the
     phase-2 bar and equal trace counts; max |d| and the differing pixels
     are printed (they are expected to be 0).
  B. cluster_nearest ("cull" and "dense") vs the dense tester on the
     frame's primary rays and on one bounce's rays: t bit-equal, ids equal.
  C. the fused kernel vs the JAX oracle stored in
     tests/data/torch_port_golden_mesh.npz, with phase 3's bar.
  D. timing with CUDA events: the fused kernel alone and with its wrapper
     (visit order and packing), the plain version, one line at 100k
     spheres, and cluster_nearest on the primary rays; each kernel's bound,
     from the narrow tests its traces need (for the fused kernel, every
     trace of the frame, counted on one more run of the plain version).
  E. the main paths of the many-object tier: 30 frames of run_animation
     (the fused kernel) and 2 frames with --renderer eager (the integrator,
     tracing through cluster_nearest), each with the launch counts set to
     0 before and read after.

The Monte-Carlo path tracer (--pathtrace), through the path-tracing kernel
(csrc/pathtrace.cu), with the demo's area light:

  P1. the kernel vs its plain version, both on the card, at 480x280, 10
      spp, 10 bounces: the 'colors' sky at the frame seeds of t = 0.7 and
      3.3, and one frame each with 'uv_checker' and with --bilinear. Bar:
      phase 2's; max |d|, the differing pixels and both sides' work
      (nearest-hit traces, hits, unblocked shadow rays) are printed (the
      differences are expected to be 0).
  P2. the kernel vs JAX's kernel stored in
      tests/data/torch_port_golden_pathtrace.npz (PATHTRACE_BAR).
  P3. timing: the wrapper (CUDA events, median of 20), the kernel alone
      (torch.profiler), the plain version; traces a frame and Mray/s from
      the plain version's count; the kernel's bound from the FP32
      operations its work needs (the PT_* counts).
  P4. the main path: 30 frames of run_animation(..., pathtrace=True), the
      launch counts set to 0 before and read after, then one frame of the
      eager estimator on the card, whose image mean must be within 0.01 of
      the kernel's frame, and one frame of --pathtrace --scene many (the
      estimator, tracing through cluster_nearest).

Image cubemaps ('milky_way', the 256-texel starfield; the texels loaded in
the kernels), the sky weights and the pixel-rate frame (csrc/render.cu,
csrc/mesh.cu):

  S1. the demo kernel vs its plain version at the full config, milky_way
      at t = 0.0, 1.5, 7.3, bilinear at 1.5, and a 1024-texel starfield
      (25 MB of texels, past JAX's dim <= 591 cap) at 1.5. Bar: bit for
      bit (max |d| 0, no differing pixel, equal traces).
  S2. the fused kernel vs its plain version, bit for bit: milky_way at
      480x280 (phase D's geometry, whose traces it must repeat) and
      bilinear at 240x140.
  S3. both kernels vs the JAX oracle stored in
      tests/data/torch_port_golden_sky.npz (demo and many-object frames,
      nearest and bilinear), with phase 3's and phase C's bars.
  S4. timing under milky_way: the demo wrapper and kernel, nearest and
      bilinear, the fused wrapper and kernel; then the main paths, each
      with the launch counts set to 0 before and read after: 60 frames of
      the demo, 30 of --scene many, one of --pathtrace (the eager
      estimator: no kernel or plain-version launch), and FACE_FRAMES each
      of the demo and --scene many with --skybox <dir> --bilinear (six
      seeded FACE_DIM-texel faces written as PPM). The sky-weight and
      pixel-rate kernels have no caller on these paths: their counts are
      read too and must stay 0, and the kernels line reports them so.
  S5. the sky-weight kernel (sky_weights) vs its plain version, bit for
      bit; its time and bound.
  S6. the pixel-rate kernel (render_frame_pixel_rate) vs its plain version
      and vs render_frame_cuda, bit for bit; its time and bound.

Multi-device rendering (--mesh, ttrt_torch/parallel/) and the kernels'
lifted caps; every decomposition a mesh would give is checked on the one
card through the sharded renderers' pure combine functions:

  M0. the demo and path-tracing kernels on a 70-sphere, 9 + 9-light demo
      scene at the full config (the scene in shared memory) and on a
      1400-sphere scene at 64x32 (past 48 KB: read in place), and the
      fused kernel on a 2240-sphere scene with 9 + 9 lights: bit for bit
      equal to their plain versions, traces and work included.
  M1. render_band_cuda (the demo kernel's band form, samples summed) over
      the decompositions 4x1, 2x2 and 1x2, 'colors' and 'milky_way'
      bilinear, put together with parallel.sharding.combine_bands: one
      sample slice a band equals render_frame_cuda bit for bit, more are
      within sum_bound(N) (the N-term sum reassociated); one band against
      its plain version, bit for bit; the band launch's times and bound.
  M2. the path tracer's sum mode against its plain version, bit for bit;
      4 device streams (parallel.sharding.device_seed) at 3 spp combined
      against one 12-spp frame (image means); its times, and the mean
      mode's kernel alone.
  M3. the fused kernel's 2x2 bands at 10k spheres against its whole
      frame, within sum_bound(N), equal traces.
  M4. cluster_nearest_cuda on 2 and 4 objects shards of the 10k-sphere
      pack, merged (parallel.objects.merge_nearest), against the whole
      pack on phase B's 1,344,000 primary rays: t and ids bit for bit; a
      shard's times and bound.
  M5. the main paths through --mesh on a one-rank NCCL process group
      (run_animation(..., mesh_spec=...), torn down after each): 60 demo
      frames, 10 --pathtrace frames, 5 --scene many frames with mesh
      'auto', and 2 frames of --scene many on '1x1x1' (the objects axis),
      each with the launch counts set to 0 before and read after: the
      kernels' counts rise, the plain versions' stay 0.

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
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(REPO, "tests", "data", "torch_port_golden.npz")
MESH_GOLDEN = os.path.join(REPO, "tests", "data",
                           "torch_port_golden_mesh.npz")
PT_GOLDEN = os.path.join(REPO, "tests", "data",
                         "torch_port_golden_pathtrace.npz")
SKY_GOLDEN = os.path.join(REPO, "tests", "data", "torch_port_golden_sky.npz")
KNIFE_CAP = 0.20  # K1 | K2 share of pixels (tests/test_pallas_kernel.py)
# the many-object scene has far more silhouettes (tests/test_mesh_fused.py)
MESH_KNIFE_CAP = 0.40
# the image-sky golden (the starfield, nearest and bilinear; masks united
# with the 'colors' sky's, tests/make_torch_golden.py): K1 | K2 cover
# 12.7-19.4% of the demo frames' pixels and 27.7-36.1% of the many-object
# frames' (JAX's own textured-bilinear case runs at 0.30,
# tests/test_pallas_kernel.py)
SKY_KNIFE_CAP = 0.25
SKY_MESH_KNIFE_CAP = MESH_KNIFE_CAP
# Flipped pixels, all inside the knife classes, allowed against the
# golden: 3% on the demo scene (tests/knife_util.py); 10% on the
# many-object golden, whose 10 bounces through 2240 small spheres carry a
# knife-edge difference on to every later bounce. JAX's own fused kernel
# (interpret mode, on the CPU) flips 144 and 114 of its 2048 pixels (7.0%,
# 5.6%) against the same oracle frames.
FLIP_CAP = 0.03
MESH_FLIP_CAP = 0.10
N_FRAMES = 60
MESH_FRAMES = 30
EAGER_FRAMES = 2
N_SPHERES = 10_000
PT_FRAMES = 30
# phase S4's --skybox <dir> main paths: frames each, and the faces' dim
FACE_FRAMES = 5
FACE_DIM = 96
# PATHTRACE_BAR: the path-tracing kernel (or its plain version) against
# JAX's kernel on the same scene and frame seed. Both draw the same random
# stream, so most pixels agree to float32 rounding; a ray whose direction
# XLA's rsqrt and fused multiply-adds round differently can cross a knife
# edge and take another path. At most PT_SHARE of the pixels may differ by
# more than PT_TOL in a channel, and the image means agree within
# PT_MEAN_TOL. Measured on the CPU (tests/pathtrace_gap.py): 0 pixels at
# 16x8x2x3, 3 and 7 of 2048 on the 10-bounce golden.
PT_TOL = 1e-5
PT_SHARE = 0.02
PT_MEAN_TOL = 1e-3
# The eager estimator against the kernel: two random streams, one
# estimator; image means of 10-sample frames (tests/test_pathtrace_pallas.py)
PT_ESTIMATOR_MEAN_TOL = 0.01

# The card's peaks for the bounds (NVIDIA H100 SXM data sheet, at 700 W):
# FP32 outside the tensor cores, and device memory.
PEAK_FP32 = 67e12  # operations/s
PEAK_BYTES = 3.35e12  # bytes/s
# Floating-point operations (add, sub, mul, div, sqrt, min, max; an fma
# counts 2) of the kernels' inner tests, counted from the CUDA sources:
DEMO_SHADOW_SPHERE_OPS = 19  # render.cu blocked(), one sphere
DEMO_SHADOW_PLANE_OPS = 14  # render.cu blocked(), the ground plane
SLAB_OPS = 25  # mesh.cu quarter(): 6 sub, 6 mul, 13 min/max
SPHERE_OPS = 18  # mesh.cu sphere_t(), no root (a miss)
TRI_OPS = 46  # mesh.cu tri_t(): 3 cross products, 4 dots, 1 div, ...
# pathtrace.cu and the common.cuh device functions it calls (cosf and sinf
# count 1 each; comparisons, conversions and the Russian roulette are left
# out, so the count is a floor):
PT_TRACE_OPS = 20  # DemoTracer::trace(): setup (a, 1/2a) 6, the plane 14
PT_TRACE_SPHERE_OPS = 20  # trace(), one sphere, no root
PT_HIT_OPS = 35  # finish_hit() (plane form: no center)
PT_MISS_OPS = 10  # miss_hit(): one normalize3
PT_SHADOW_SPHERE_OPS = 21  # blocked() with tmax, one sphere
PT_SHADOW_PLANE_OPS = 14  # blocked(), the plane; a blocked ray's floor
PT_NEE_OPS = 61  # a light sample, direction, falloff and radiance update
PT_CONTINUE_OPS = 23  # the branch draw, a mirror direction, normalize3
PT_PATH_OPS = 129  # the jittered primary ray (44), the sky and the sum (85)


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


def golden_bar(ref, out, k1, k2, rays_ref, rays,
               knife_cap: float = KNIFE_CAP,
               flip_cap: float = FLIP_CAP) -> dict:
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
    assert stats["knife_share"] <= knife_cap, stats
    assert stats["flip_px"] <= flip_cap * knife.size, stats
    assert stats["max_abs_off_knife"] < 0.5 / 255, stats
    assert stats["median_abs"] < 2e-5, stats
    assert _rays_close(rays_ref, rays), stats
    return stats


def check_golden(render, device, path: str = GOLDEN,
                 knife_cap: float = KNIFE_CAP,
                 flip_cap: float = FLIP_CAP) -> list:
    """Render every frame of a JAX golden (``path``: the demo's, or the
    many-object scene's ``MESH_GOLDEN``) with ``render`` (a
    ``render_frame``-like function) on ``device`` and hold it to the
    golden's bar. Returns one stats dict per frame."""
    g = np.load(path)
    cfg = _golden_cfg(g)
    out = []
    for i, t in enumerate(g["times"]):
        fb, rays = render(_golden_scene(g, i, device, "colors"), cfg)
        stats = golden_bar(g[f"fb{i}"], fb.to_array().cpu().numpy(),
                           g[f"k1_{i}"], g[f"k2_{i}"], int(g[f"rays{i}"]),
                           int(rays), knife_cap, flip_cap)
        out.append({"t": float(t), **stats})
    return out


def _golden_cfg(g, **flags):
    """The RenderConfig of a golden file's ``config`` (width, height, spp,
    bounces, ...)."""
    from ttrt_torch.config import RenderConfig

    width, height, spp, bounces = (int(v) for v in g["config"][:4])
    return RenderConfig(width=width, height=height, rays_per_pixel=spp,
                        bounce_limit=bounces, **flags)


def _golden_scene(g, i: int, device, procedural):
    """Frame ``i``'s scene of a golden file, on ``device``."""
    import torch

    from ttrt_torch.scene import scene_from_numpy

    prefix = f"scene{i}."
    leaves = {k[len(prefix):]: g[k] for k in g.files if k.startswith(prefix)}
    return scene_from_numpy(leaves, procedural, device=device,
                            dtype=torch.float32)


def check_sky_golden(render, render_mesh, device) -> list:
    """Render every frame of the image-sky golden (``SKY_GOLDEN``: the
    demo scene and the many-object scene under the untagged starfield,
    nearest and bilinear) on ``device``, the demo frames with ``render``
    and the many-object ones with ``render_mesh``, and hold each to phase
    3's bar (phase C's for the many-object frames). Returns one stats dict
    per frame."""
    g = np.load(SKY_GOLDEN)
    out = []
    for i, t in enumerate(g["times"]):
        mesh, bilinear = bool(g["mesh"][i]), bool(g["bilinear"][i])
        fb, rays = (render_mesh if mesh else render)(
            _golden_scene(g, i, device, None),
            _golden_cfg(g, skybox_bilinear=bilinear))
        caps = ((SKY_MESH_KNIFE_CAP, MESH_FLIP_CAP) if mesh
                else (SKY_KNIFE_CAP, FLIP_CAP))
        stats = golden_bar(g[f"fb{i}"], fb.to_array().cpu().numpy(),
                           g[f"k1_{i}"], g[f"k2_{i}"], int(g[f"rays{i}"]),
                           int(rays), *caps)
        out.append({"t": float(t), "mesh": mesh, "bilinear": bilinear,
                    **stats})
    return out


def pathtrace_stats(ref, out) -> dict:
    """PATHTRACE_BAR's statistics of (H, W, 3) frames: max |d|, the pixels
    that differ by more than PT_TOL in a channel and their share, and the
    difference of the image means."""
    d = np.abs(np.asarray(ref, np.float64) - np.asarray(out, np.float64))
    differ = (d > PT_TOL).any(axis=-1)
    return {"max_abs": float(d.max()), "differ_px": int(differ.sum()),
            "share": float(differ.mean()),
            "mean_delta": float(np.mean(out) - np.mean(ref))}


def pathtrace_bar(ref, out) -> dict:
    """PATHTRACE_BAR on (H, W, 3) frames of the same scene and seed."""
    stats = pathtrace_stats(ref, out)
    assert stats["share"] <= PT_SHARE, stats
    assert abs(stats["mean_delta"]) < PT_MEAN_TOL, stats
    return stats


def check_pathtrace_golden(pathtrace_frame, device,
                           bar=pathtrace_bar) -> list:
    """Path-trace every frame of the stored JAX path-tracer golden with
    ``pathtrace_frame`` (a ``kernels.pathtrace.pathtrace_frame``-like
    function) on ``device`` and hold it to ``bar`` (PATHTRACE_BAR; or
    ``pathtrace_stats`` only to measure). Returns one stats dict per
    frame."""
    import torch

    from ttrt_torch.render.pathtrace import AreaLights

    g = np.load(PT_GOLDEN)
    cfg = _golden_cfg(g)
    lights = AreaLights.from_numpy(
        {k[len("lights."):]: g[k] for k in g.files
         if k.startswith("lights.")}, dtype=torch.float32, device=device)
    out = []
    for i, t in enumerate(g["times"]):
        scene = _golden_scene(g, i, device, "colors")
        fb, _ = pathtrace_frame(scene, lights, cfg, int(g[f"seed{i}"]))
        stats = bar(g[f"fb{i}"], fb.to_array().cpu().numpy())
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


def exact_bar(ref: np.ndarray, out: np.ndarray, rays_ref, rays) -> dict:
    """A culled kernel against its exhaustive plain version: the phase-2
    bar, equal trace counts, and the size of any difference (expected 0:
    both keep the lowest id on ties, so the culling changes nothing)."""
    stats = plain_bar(ref, out, rays_ref, rays)
    d = np.abs(np.asarray(ref, np.float64) - np.asarray(out, np.float64))
    stats["diff_px"] = int((d > 0).any(axis=-1).sum())
    assert int(rays_ref) == int(rays), stats
    return stats


def nearest_bar(ref, out) -> dict:
    """cluster_nearest against the dense tester: t bit-equal (inf on the
    same misses), ids equal."""
    t_ref, t = ref.t.cpu().numpy(), out.t.cpu().numpy()
    id_ref, ids = ref.obj.cpu().numpy(), out.obj.cpu().numpy()
    both = np.isfinite(t_ref) & np.isfinite(t)
    stats = {"rays": int(t.size), "hits": int((id_ref >= 0).sum()),
             "t_diff": int((t_ref != t).sum()),
             "id_diff": int((id_ref != ids).sum()),
             "max_abs_t": float(np.abs(t_ref[both] - t[both]).max(
                 initial=0.0))}
    assert stats["t_diff"] == 0 and stats["id_diff"] == 0, stats
    return stats


def bound_ms(ops: float, nbytes: float):
    """The least time the card could take: the larger of the operations
    over the FP32 peak and the bytes over the memory rate, and which of
    the two it is."""
    t_ops = 1e3 * ops / PEAK_FP32
    t_bytes = 1e3 * nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def quarter_work(pack):
    """The pack's quarters as built (not widened by the kernel tables'
    pad; empty quarters dropped): lo and hi (Q, 3), their real objects
    (Q,) and the FP32 operations of narrow-testing those objects (Q,)."""
    import torch

    from ttrt_torch.mesh.clusters import quarter_boxes

    lo, hi = quarter_boxes(pack)
    n = pack.tables.qbox[:, 6]
    is_tri = torch.arange(n.numel(), device=n.device) >= 4 * pack.kb_sph
    ops = n * torch.where(is_tri, float(TRI_OPS), float(SPHERE_OPS))
    keep = n > 0
    return lo[keep], hi[keep], n[keep], ops[keep]


def narrow_work(boxes, o, d, limit):
    """(objects, operations) as 0-dim tensors: over the rays (o, d), the
    real objects of every quarter whose box a ray enters at a t no later
    than its ``limit`` (its nearest hit, inf on a miss; where an unblocked
    shadow ray ends), and the FP32 operations of their narrow tests. A
    culled nearest-hit walk in any order must test at least these: its
    best t never falls below the final hit."""
    import torch

    lo, hi, n, ops = boxes
    objs = torch.zeros((), dtype=torch.float64, device=n.device)
    flops = torch.zeros_like(objs)
    for r0 in range(0, o.x.numel(), 1 << 16):
        sl = slice(r0, r0 + (1 << 16))
        tn = torch.zeros_like(o.x[sl])[:, None]
        tf = torch.full_like(tn, float("inf"))
        for i, (oc, dc) in enumerate(zip(o, d)):
            m = torch.clamp_min(dc[sl].abs(), 1e-12)
            iv = (1.0 / torch.where(dc[sl] >= 0.0, m, -m))[:, None]
            t1 = (lo[None, :, i] - oc[sl][:, None]) * iv
            t2 = (hi[None, :, i] - oc[sl][:, None]) * iv
            tn = torch.maximum(tn, torch.minimum(t1, t2))
            tf = torch.minimum(tf, torch.maximum(t1, t2))
        live = ((tf >= tn) & (tn <= limit[sl][:, None])).to(n.dtype)
        objs += (live @ n).sum(dtype=torch.float64)
        flops += (live @ ops).sum(dtype=torch.float64)
    return objs, flops


def frame_work(scene, cfg, boxes) -> dict:
    """Every trace of one frame and the narrow tests it needs, counted on
    a run of the fused kernel's plain version (which makes the kernel's
    traces, bounce by bounce): each nearest-hit trace needs the objects
    of ``narrow_work`` before its hit; an unblocked shadow ray those
    before its point light (all it enters, for a directional light); a
    blocked one at least the one test that finds its blocker. Returns the
    traces and narrow tests by kind (primary, bounce, shadow) and the
    narrow tests' FP32 operations."""
    import torch

    from ttrt_torch.kernels import mesh_fused
    from ttrt_torch.vec import Vec3

    real_nearest = mesh_fused.nearest_arrays
    real_shadow = mesh_fused._shadow_blocked
    count = {k: [0, 0.0] for k in ("primary", "bounce", "shadow")}
    flops = []
    state = {}

    def nearest(sph, tri, n_sph, o, d):
        gh = real_nearest(sph, tri, n_sph, o, d)
        kind = "bounce" if state else "primary"
        objs, ops = narrow_work(boxes, o, d, gh.t)
        count[kind][0] += gh.t.numel()
        count[kind][1] += objs
        flops.append(ops)
        state["hit"] = gh.obj >= 0
        return gh

    def shadow(sph, tri, px, py, pz, lx, ly, lz, tmax):
        blocked = real_shadow(sph, tri, px, py, pz, lx, ly, lz, tmax)
        hit = state["hit"]
        assert hit.shape == blocked.shape, (hit.shape, blocked.shape)
        free = torch.nonzero(hit & ~blocked)[:, 0]
        n_blocked = int((hit & blocked).sum())
        p = Vec3(px[free], py[free], pz[free])
        ld = Vec3(*(torch.broadcast_to(v, px.shape)[free]
                    for v in (lx, ly, lz)))
        end = (torch.full_like(p.x, float("inf")) if tmax is None
               else tmax[free])
        objs, ops = narrow_work(boxes, p, ld, end)
        count["shadow"][0] += free.numel() + n_blocked
        count["shadow"][1] += objs + n_blocked
        flops.append(ops + n_blocked * SPHERE_OPS)
        return blocked

    mesh_fused.nearest_arrays = nearest
    mesh_fused._shadow_blocked = shadow
    try:
        _, rays = mesh_fused.render_band_mesh_fused_plain(scene, cfg)
    finally:
        mesh_fused.nearest_arrays = real_nearest
        mesh_fused._shadow_blocked = real_shadow
    out = {k: [v[0], float(v[1])] for k, v in count.items()}
    out["traces"] = sum(v[0] for v in out.values())
    out["plain_traces"] = int(rays)
    out["narrow_ops"] = float(sum(flops))
    return out


def pathtrace_ops(work, n_spheres: int, n_lights: int,
                  n_paths: int) -> float:
    """FP32 operations a path-traced frame needs, from its work (nearest-
    hit traces, hits, unblocked shadow rays; the plain version's count)
    and the PT_* counts: every trace tests every sphere and the plane, a
    hit is fixed up and continued, a miss normalized; every hit samples
    each light; an unblocked shadow ray tests every sphere and the plane,
    a blocked one at least the plane's test; every path makes its
    primary ray and folds the sky."""
    nearest, hits, unblocked = (int(v) for v in work)
    shadow = hits * n_lights
    return float(
        nearest * (PT_TRACE_OPS + n_spheres * PT_TRACE_SPHERE_OPS)
        + hits * (PT_HIT_OPS + PT_CONTINUE_OPS + n_lights * PT_NEE_OPS)
        + (nearest - hits) * PT_MISS_OPS
        + unblocked * (n_spheres * PT_SHADOW_SPHERE_OPS
                       + PT_SHADOW_PLANE_OPS)
        + (shadow - unblocked) * PT_SHADOW_PLANE_OPS
        + n_paths * PT_PATH_OPS)


def crowd_arrays(n_spheres: int, n_dlights: int, n_plights: int,
                 seed: int = 0) -> dict:
    """Seeded numpy leaves of a crowded demo scene, keyed by field path as
    ``scene_from_numpy`` reads them: ``n_spheres`` spheres on a jittered
    grid (1.4 m, or finer for more than 96 spheres) around the camera's
    orbit, none touching another or the ground, under ``n_dlights``
    directional and ``n_plights`` point lights above them, dim enough that
    the lights do not saturate every surface. Past the kernels' old caps
    (64 spheres, 8 + 8 lights)."""
    rng = np.random.default_rng(seed)
    f = lambda a: np.asarray(a, np.float32)  # noqa: E731
    step = 1.4
    while True:
        grid = np.arange(-7.0, 7.0 + step / 2, step)
        cells = np.array([(x, z) for x in grid for z in grid
                          if max(abs(x), abs(z)) > 3.0])
        if len(cells) >= n_spheres:
            break
        step *= 0.9
    pick = cells[rng.choice(len(cells), n_spheres, replace=False)]
    radius = rng.uniform(0.14, 0.32, n_spheres) * step
    jitter = lambda: rng.uniform(-0.14, 0.14, n_spheres) * step  # noqa: E731
    center = np.stack([pick[:, 0] + jitter(),
                       rng.uniform(-1.5, 1.5, n_spheres),
                       pick[:, 1] + jitter()], -1)
    out = {}
    for i, c in enumerate("xyz"):
        out[f"spheres.center.{c}"] = f(center[:, i])
        out[f"spheres.material.color.{c}"] = f(
            rng.uniform(0.1, 1.0, n_spheres))
    out["spheres.radius"] = f(radius)
    out["spheres.material.reflectivity"] = f(rng.uniform(0.0, 0.8, n_spheres))
    out["spheres.material.specularity"] = f(np.full(n_spheres, 100.0))
    direction = rng.normal(size=(n_dlights, 3))
    direction[:, 1] = -np.abs(direction[:, 1]) - 1.0
    position = rng.uniform([-6.0, 3.0, -6.0], [6.0, 6.0, 6.0], (n_plights, 3))
    for i, c in enumerate("xyz"):
        out[f"directional_lights.direction.{c}"] = f(direction[:, i])
        out[f"directional_lights.color.{c}"] = f(
            rng.uniform(0.02, 0.1, n_dlights))
        out[f"point_lights.position.{c}"] = f(position[:, i])
        out[f"point_lights.color.{c}"] = f(rng.uniform(0.05, 0.2, n_plights))
    out["point_lights.intensity"] = f(rng.uniform(2.0, 12.0, n_plights))
    return out


def crowd(scene, n_spheres: int, n_dlights: int, n_plights: int,
          seed: int = 0):
    """``scene`` with ``crowd_arrays``' lights and, for a demo ``Scene``
    (``n_spheres`` > 0), its spheres, on its device and in its dtype; a
    ``MeshScene`` keeps its spheres and their cluster pack."""
    import torch

    from ttrt_torch.scene import (DirectionalLights, Materials, PointLights,
                                  Spheres)
    from ttrt_torch.vec import Vec3

    a = crowd_arrays(max(n_spheres, 1), n_dlights, n_plights, seed)
    like = scene.spheres.radius
    t = lambda k: torch.as_tensor(a[k], dtype=like.dtype,  # noqa: E731
                                  device=like.device)
    v = lambda p: Vec3(t(p + ".x"), t(p + ".y"), t(p + ".z"))  # noqa: E731
    scene = scene._replace(
        directional_lights=DirectionalLights(
            v("directional_lights.direction"), v("directional_lights.color")),
        point_lights=PointLights(v("point_lights.position"),
                                 v("point_lights.color"),
                                 t("point_lights.intensity")))
    if not n_spheres:
        return scene
    return scene._replace(spheres=Spheres(
        v("spheres.center"), t("spheres.radius"),
        Materials(v("spheres.material.color"),
                  t("spheres.material.reflectivity"),
                  t("spheres.material.specularity"))))


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


def _kernel_ms(fn, name: str, reps: int = 20) -> float:
    """Mean device time of the one kernel whose name holds ``name`` over
    ``reps`` calls of ``fn``, from torch.profiler."""
    import torch

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    (row,) = [e for e in prof.key_averages() if name in e.key]
    return row.self_device_time_total / row.count / 1e3


def demo_bound(rays: int, n_px: int, texel_bytes: int = 0):
    """The demo kernel's bound (``bound_ms``): every trace costs at least a
    shadow trace (the cheaper kind) against the 6 spheres and the plane;
    it reads the packed scene and the sky's texels (an image sky's, once)
    and writes 16 bytes a pixel."""
    return bound_ms(
        rays * (6 * DEMO_SHADOW_SPHERE_OPS + DEMO_SHADOW_PLANE_OPS),
        4 * (17 + 9 * 6 + 16 + 6 + 7) + texel_bytes + 16 * n_px)


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
        if any(k in line for k in ("entry function", "registers", "spill")):
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
             ("colors", 1.5, {"energy_model": "subtract"}),
             ("uv_checker", 1.5, {"skybox_bilinear": True})]
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
    kernel_device_ms = _kernel_ms(
        lambda: render_frame_cuda(scene, full, count_rays=False),
        "render_kernel")
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
    render_bound = demo_bound(rays, full.width * full.height)
    kernels = [{
        "name": "render",
        "route": "cuda",
        "source": "ttrt_torch/kernels/csrc/render.cu",
        "replaces": "ttrt/kernels/render_pallas.py:894",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": render_bound[0],
        "bound_by": render_bound[1],
        "library_ms": None,  # no single PyTorch call renders a frame
    }]
    mesh_kernels, fused_work = mesh_phases(card, dev, full)
    kernels += mesh_kernels
    kernels.append(pathtrace_phases(card, dev, full))
    kernels += sky_phases(card, dev, full, fused_work)
    kernels += mesh_axis_phases(card, dev, full)

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


def mesh_phases(card: str, dev, full) -> tuple:
    """Phases A-E; returns the two mesh kernels' entries of the kernels
    line, and the work of phase D's fused frame (its scene time, traces,
    and the FP32 operations and bytes of its bound)."""
    import torch

    from ttrt_torch import app, assets
    from ttrt_torch.frames import orbit_camera_frame
    from ttrt_torch.kernels import mesh, mesh_fused
    from ttrt_torch.mesh.dense import dense_nearest
    from ttrt_torch.mesh.scene import many_sphere_scene, trace_ray_mesh
    from ttrt_torch.render.integrator import generate_rays
    from ttrt_torch.utils.profiling import StageTimers
    from ttrt_torch.vec import Vec3

    fused_cuda = mesh_fused.render_band_mesh_fused_cuda
    fused_plain = mesh_fused.render_band_mesh_fused_plain
    skies = {}

    def scene_at(t: float, sky: str = "colors", n: int = N_SPHERES):
        if sky not in skies:
            skies[sky] = assets.load_skybox(sky, device=dev)
        scene = many_sphere_scene(skies[sky], n, full.width, full.height,
                                  dtype=torch.float32, device=dev)
        return scene.with_camera_frame(
            orbit_camera_frame(t, dtype=torch.float32, device=dev))

    def frame(fb) -> np.ndarray:
        out = fb.to_array().cpu().numpy()
        assert out.shape == (full.height, full.width, 3), out.shape
        assert np.isfinite(out).all()
        return out

    # -- phase A: the fused kernel vs its plain version ----------------------
    scene = scene_at(0.7)
    pack = scene.clusters
    K = pack.kb_sph + pack.kb_tri
    print(f"phase A: {N_SPHERES} spheres, {scene.triangles.count} "
          f"triangles, {K} subclusters of 128 objects")
    cases = [(0.7, "colors", {}), (3.3, "colors", {}),
             (3.3, "colors", {"specular": True}),
             (3.3, "colors", {"energy_model": "subtract"}),
             (3.3, "uv_checker", {"skybox_bilinear": True})]
    fused_err = 0.0
    for t, sky, flags in cases:
        scene = scene_at(t, sky)
        cfg = full.with_(**flags)
        t0 = time.perf_counter()
        fb_k, rays_k = fused_cuda(scene, cfg)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fb_p, rays_p = fused_plain(scene, cfg)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        stats = exact_bar(frame(fb_p), frame(fb_k), rays_p, rays_k)
        fused_err = max(fused_err, stats["max_abs"])
        print(f"phase A: {sky} t={t} {flags or ''} {json.dumps(stats)} "
              f"(kernel "
              f"{t1 - t0:.3f} s, plain {t2 - t1:.3f} s, host clock)")

    # -- phase B: cluster_nearest vs the dense tester ------------------------
    scene = scene_at(3.3)
    pack = scene.clusters
    o, d = generate_rays(scene, full)
    o = Vec3(*(c.contiguous() for c in o))
    ref = dense_nearest(scene.spheres, scene.triangles, o, d)
    nearest_err = 0.0
    for mode in ("cull", "dense"):
        stats = nearest_bar(ref, mesh.cluster_nearest_cuda(pack, o, d,
                                                           mode=mode))
        nearest_err = max(nearest_err, stats["max_abs_t"])
        print(f"phase B: primary rays, mode {mode}: {json.dumps(stats)}")
    hit = trace_ray_mesh(scene, o, d, sample_sky=False)
    keep = torch.nonzero(hit.kind != 0)[:, 0]
    o2 = Vec3(*(c[keep] for c in hit.point))
    d2 = Vec3(*(c[keep] for c in d)).reflect(
        Vec3(*(c[keep] for c in hit.normal))).normalize()
    ref2 = dense_nearest(scene.spheres, scene.triangles, o2, d2)
    stats = nearest_bar(ref2, mesh.cluster_nearest_cuda(pack, o2, d2))
    nearest_err = max(nearest_err, stats["max_abs_t"])
    print(f"phase B: first-bounce rays, mode cull: {json.dumps(stats)}")
    torch.cuda.synchronize()

    # -- phase C: the fused kernel vs the stored JAX oracle ------------------
    for stats in check_golden(mesh_fused.render_frame_mesh_fused, dev,
                              MESH_GOLDEN, MESH_KNIFE_CAP, MESH_FLIP_CAP):
        print(f"phase C: golden {json.dumps(stats)}")
    torch.cuda.synchronize()

    # -- phase D: timing and bounds ------------------------------------------
    _, rays = fused_cuda(scene, full)
    rays = int(rays)
    fused_ms = _median_ms(lambda: fused_cuda(scene, full))
    fused_kernel_ms = _kernel_ms(lambda: fused_cuda(scene, full),
                                 "mesh_fused_kernel", reps=5)
    fused_plain_ms = _median_ms(lambda: fused_plain(scene, full), reps=1,
                                warmup=0)
    table_bytes = sum(v.numel() * v.element_size() for v in pack.tables
                      if isinstance(v, torch.Tensor))
    boxes = quarter_work(pack)
    n_quarters = boxes[0].shape[0]
    work = frame_work(scene, full, boxes)
    assert work["traces"] == work["plain_traces"] == rays, (work, rays)
    fused_work = {"t": 3.3, "rays": rays,
                  "ops": rays * n_quarters * SLAB_OPS + work["narrow_ops"],
                  "bytes": table_bytes + 16 * full.width * full.height}
    fused_bound = bound_ms(fused_work["ops"], fused_work["bytes"])
    per_kind = {k: [work[k][0], round(work[k][1] / max(work[k][0], 1), 2)]
                for k in ("primary", "bounce", "shadow")}
    print(f"phase D [{card}]: fused kernel, 480x280x10spp, 10 bounces, "
          f"{N_SPHERES} spheres: {rays} traces; wrapper {fused_ms:.4f} "
          f"ms/frame = {rays / fused_ms / 1e3:.1f} Mray/s (CUDA events, "
          f"median of 20), kernel alone {fused_kernel_ms:.4f} ms "
          f"(torch.profiler, mean of 5), plain version {fused_plain_ms:.3f} "
          f"ms; bound {fused_bound[0]:.4f} ms by {fused_bound[1]} "
          f"({n_quarters} slab tests a trace; narrow tests counted on every "
          f"trace of the frame, [traces, mean a trace] by kind: "
          f"{json.dumps(per_kind)}; {work['narrow_ops']:.6e} narrow-test "
          f"operations)")

    n_rays = o.x.numel()
    near_ms = _median_ms(lambda: mesh.cluster_nearest_cuda(pack, o, d))
    dense_ms = _median_ms(
        lambda: dense_nearest(scene.spheres, scene.triangles, o, d), reps=3,
        warmup=1)
    t_best = mesh.cluster_nearest_cuda(pack, o, d).t
    near_objs, near_ops = narrow_work(boxes, o, d, t_best)
    near_bound = bound_ms(n_rays * n_quarters * SLAB_OPS + float(near_ops),
                          table_bytes + 32 * n_rays)
    print(f"phase D [{card}]: cluster_nearest on the {n_rays} primary rays: "
          f"{near_ms:.4f} ms = {n_rays / near_ms / 1e3:.1f} Mray/s (CUDA "
          f"events, median of 20), dense tester {dense_ms:.3f} ms; bound "
          f"{near_bound[0]:.4f} ms by {near_bound[1]} ({n_quarters} slab "
          f"tests and {float(near_objs) / n_rays:.2f} narrow tests a ray)")

    big = scene_at(3.3, n=100_000)
    _, big_rays = fused_cuda(big, full)
    big_ms = _median_ms(lambda: fused_cuda(big, full), reps=5, warmup=1)
    print(f"phase D [{card}]: fused kernel at 100000 spheres: "
          f"{int(big_rays)} traces, wrapper {big_ms:.4f} ms/frame = "
          f"{int(big_rays) / big_ms / 1e3:.1f} Mray/s (median of 5)")
    del big
    torch.cuda.synchronize()

    # -- phase E: the many-object main paths ---------------------------------
    scene = scene_at(0.0)
    unpaced = full.with_(frame_rate=1e9)
    counters = (fused_cuda, fused_plain, mesh.cluster_nearest_cuda)
    launches = {}
    for renderer, frames in (("auto", MESH_FRAMES), ("eager", EAGER_FRAMES)):
        sink = io.BytesIO()
        timers = StageTimers()
        for fn in counters:
            fn.launches = 0
        t0 = time.perf_counter()
        app.run_animation(unpaced, "colors", max_frames=frames,
                          interactive=False, encode="device", scene=scene,
                          stream=sink, timers=timers, renderer=renderer)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[renderer] = [fn.launches for fn in counters]
        validate_stream(sink.getvalue(), full.width, full.height, frames)
        split = {name: round(st["mean_ms"], 4)
                 for name, st in timers.summary().items()}
        print(f"phase E [{card}]: --scene many --renderer {renderer}: "
              f"{frames} frames in {wall:.3f} s = {frames / wall:.2f} fps "
              f"end to end (pacing off), stage means (ms) "
              f"{json.dumps(split)}; launches fused {launches[renderer][0]} "
              f"(plain {launches[renderer][1]}), cluster_nearest "
              f"{launches[renderer][2]}")
    assert launches["auto"] == [MESH_FRAMES, 0, 0], launches
    assert launches["eager"][:2] == [0, 0], launches
    assert launches["eager"][2] > 0, launches

    return [{
        "name": "mesh_fused",
        "route": "cuda",
        "source": "ttrt_torch/kernels/csrc/mesh.cu",
        "replaces": "ttrt/kernels/mesh_fused.py:194",
        "launches": launches["auto"][0],
        "max_abs_err": fused_err,
        "ms": fused_ms,
        "plain_ms": fused_plain_ms,
        "bound_ms": fused_bound[0],
        "bound_by": fused_bound[1],
        "library_ms": None,  # no single PyTorch call renders a frame
    }, {
        "name": "cluster_nearest",
        "route": "cuda",
        "source": "ttrt_torch/kernels/csrc/mesh.cu",
        "replaces": "ttrt/kernels/mesh_pallas.py:70",
        "launches": launches["eager"][2],
        "max_abs_err": nearest_err,
        "ms": near_ms,
        "plain_ms": dense_ms,
        "bound_ms": near_bound[0],
        "bound_by": near_bound[1],
        "library_ms": None,  # no PyTorch call finds a nearest hit
    }], fused_work


def pathtrace_phases(card: str, dev, full) -> dict:
    """Phases P1-P4; returns the path-tracing kernel's entry of the
    kernels line."""
    import torch

    from ttrt_torch import app, assets
    from ttrt_torch.frames import orbit_camera_frame
    from ttrt_torch.kernels import pathtrace
    from ttrt_torch.kernels.mesh import cluster_nearest_cuda
    from ttrt_torch.mesh.scene import many_sphere_scene
    from ttrt_torch.render import pathtrace as estimator
    from ttrt_torch.scene import demo_scene
    from ttrt_torch.utils.profiling import StageTimers

    pt_cuda = pathtrace.pathtrace_frame_cuda
    pt_plain = pathtrace.pathtrace_frame_plain
    lights = estimator.default_area_lights(full, dev)

    def scene_at(sky: str, t: float):
        scene = demo_scene(assets.load_skybox(sky, device=dev), full.width,
                           full.height, dtype=torch.float32, device=dev)
        return scene.with_camera_frame(
            orbit_camera_frame(t, dtype=torch.float32, device=dev))

    def frame(fb) -> np.ndarray:
        out = fb.to_array().cpu().numpy()
        assert out.shape == (full.height, full.width, 3), out.shape
        assert np.isfinite(out).all()
        assert out.min() >= 0.0 and out.max() <= 1.0
        return out

    # -- phase P1: the path-tracing kernel vs its plain version --------------
    cases = [("colors", 0.7, {}), ("colors", 3.3, {}),
             ("uv_checker", 3.3, {}),
             ("uv_checker", 3.3, {"skybox_bilinear": True})]
    pt_err = 0.0
    for sky, t, flags in cases:
        scene = scene_at(sky, t)
        cfg = full.with_(**flags)
        seed = pathtrace.frame_seed(0, t)
        fb_k, work_k = pt_cuda(scene, lights, cfg, seed)
        fb_p, work_p = pt_plain(scene, lights, cfg, seed)
        torch.cuda.synchronize()
        stats = plain_bar(
            frame(fb_p), frame(fb_k),
            pathtrace.total_traces(work_p, lights.count),
            pathtrace.total_traces(work_k, lights.count))
        d = np.abs(frame(fb_p).astype(np.float64) - frame(fb_k))
        stats["diff_px"] = int((d > 0).any(axis=-1).sum())
        stats["work"] = [int(v) for v in work_k]
        stats["work_ref"] = [int(v) for v in work_p]
        pt_err = max(pt_err, stats["max_abs"])
        print(f"phase P1: {sky} t={t} seed={seed} {flags or ''} "
              f"{json.dumps(stats)}")

    # -- phase P2: the kernel vs the stored JAX kernel -----------------------
    for stats in check_pathtrace_golden(pt_cuda, dev):
        print(f"phase P2: golden {json.dumps(stats)}")
    torch.cuda.synchronize()

    # -- phase P3: timing and bound ------------------------------------------
    scene = scene_at("colors", 0.7)
    seed = pathtrace.frame_seed(0, 0.7)
    _, work = pt_plain(scene, lights, full, seed)
    traces = pathtrace.total_traces(work, lights.count)
    pt_ms = _median_ms(
        lambda: pt_cuda(scene, lights, full, seed, count_rays=False))
    pt_kernel_ms = _kernel_ms(
        lambda: pt_cuda(scene, lights, full, seed, count_rays=False),
        "pathtrace_kernel")
    pt_plain_ms = _median_ms(
        lambda: pt_plain(scene, lights, full, seed, count_rays=False),
        reps=3, warmup=1)
    n_px = full.width * full.height
    n_sph = scene.spheres.count
    pt_bound = bound_ms(
        pathtrace_ops(work, n_sph, lights.count, n_px * full.rays_per_pixel),
        4 * (17 + 9 * n_sph + 16 + 8 * lights.count) + 20 * n_px)
    print(f"phase P3 [{card}]: path tracer, 480x280x10spp, 10 bounces, "
          f"colors t=0.7: work (nearest-hit traces, hits, unblocked shadow "
          f"rays) {[int(v) for v in work]} = {traces} traces; wrapper "
          f"{pt_ms:.4f} ms/frame = {traces / pt_ms / 1e3:.1f} Mray/s (CUDA "
          f"events, median of 20), kernel alone {pt_kernel_ms:.4f} ms = "
          f"{traces / pt_kernel_ms / 1e3:.1f} Mray/s (torch.profiler, mean "
          f"of 20), plain version {pt_plain_ms:.3f} ms (median of 3); bound "
          f"{pt_bound[0]:.4f} ms by {pt_bound[1]}")

    # -- phase P4: the --pathtrace main path ----------------------------------
    sink = io.BytesIO()
    timers = StageTimers()
    unpaced = full.with_(frame_rate=1e9)
    pt_cuda.launches = 0
    pt_plain.launches = 0
    t0 = time.perf_counter()
    app.run_animation(unpaced, "colors", max_frames=PT_FRAMES,
                      interactive=False, encode="device", device=dev,
                      stream=sink, timers=timers, pathtrace=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain_launches = pt_cuda.launches, pt_plain.launches
    assert launches == PT_FRAMES, launches
    assert plain_launches == 0, plain_launches
    validate_stream(sink.getvalue(), full.width, full.height, PT_FRAMES)
    split = {name: round(st["mean_ms"], 4)
             for name, st in timers.summary().items()}
    print(f"phase P4 [{card}]: --pathtrace: {PT_FRAMES} frames in "
          f"{wall:.3f} s = {PT_FRAMES / wall:.2f} fps end to end (pacing "
          f"off), stage means (ms) {json.dumps(split)}; kernel launches "
          f"{launches}, plain launches {plain_launches}")
    fb_k, _ = pt_cuda(scene, lights, full, seed, count_rays=False)
    t0 = time.perf_counter()
    fb_e = estimator.pathtrace_frame(
        scene, lights, full, torch.Generator(device=dev).manual_seed(seed))
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    mean_k, mean_e = float(frame(fb_k).mean()), float(frame(fb_e).mean())
    print(f"phase P4 [{card}]: the eager estimator, one frame in "
          f"{eager_s:.3f} s (host clock): image mean {mean_e:.6f} against "
          f"the kernel's {mean_k:.6f}")
    assert abs(mean_e - mean_k) < PT_ESTIMATOR_MEAN_TOL, (mean_e, mean_k)
    # --pathtrace --scene many: the estimator, tracing the MeshScene
    # through cluster_nearest
    many = many_sphere_scene(assets.load_skybox("colors", device=dev),
                             N_SPHERES, full.width, full.height,
                             dtype=torch.float32, device=dev)
    for fn in (pt_cuda, pt_plain, cluster_nearest_cuda):
        fn.launches = 0
    sink = io.BytesIO()
    t0 = time.perf_counter()
    app.run_animation(unpaced, "colors", max_frames=1, interactive=False,
                      encode="device", scene=many, stream=sink,
                      pathtrace=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    validate_stream(sink.getvalue(), full.width, full.height, 1)
    many_launches = [fn.launches for fn in (pt_cuda, pt_plain,
                                            cluster_nearest_cuda)]
    print(f"phase P4 [{card}]: --pathtrace --scene many ({N_SPHERES} "
          f"spheres), one frame through the eager estimator in {wall:.3f} s "
          f"(host clock); launches path tracer {many_launches[0]} (plain "
          f"{many_launches[1]}), cluster_nearest {many_launches[2]}")
    assert many_launches[:2] == [0, 0] and many_launches[2] > 0, many_launches

    return {
        "name": "pathtrace",
        "route": "cuda",
        "source": "ttrt_torch/kernels/csrc/pathtrace.cu",
        "replaces": "ttrt/kernels/pathtrace_pallas.py:101",
        "launches": launches,
        "max_abs_err": pt_err,
        "ms": pt_ms,
        "plain_ms": pt_plain_ms,
        "bound_ms": pt_bound[0],
        "bound_by": pt_bound[1],
        "library_ms": None,  # no single PyTorch call renders a frame
    }


def sky_phases(card: str, dev, full, fused_work: dict) -> list:
    """Phases S1-S6; returns the entries of the kernels line of the
    textured demo and fused kernels, the sky-weight kernel and the
    pixel-rate kernel. ``fused_work`` is phase D's fused frame, whose
    geometry phase S2 renders again under the image sky."""
    import torch

    from ttrt_torch import app, assets
    from ttrt_torch.frames import orbit_camera_frame
    from ttrt_torch.kernels import mesh_fused, pathtrace, render
    from ttrt_torch.mesh.scene import many_sphere_scene
    from ttrt_torch.scene import demo_scene
    from ttrt_torch.utils.profiling import StageTimers

    milky = assets.load_skybox("milky_way", device=dev)
    assert milky.procedural is None and milky.dim == 256
    texel_bytes = milky.packed.numel() * milky.packed.element_size()
    fused_cuda = mesh_fused.render_band_mesh_fused_cuda
    fused_plain = mesh_fused.render_band_mesh_fused_plain
    n_px = full.width * full.height
    unpaced = full.with_(frame_rate=1e9)

    def posed(scene, t: float):
        return scene.with_camera_frame(
            orbit_camera_frame(t, dtype=torch.float32, device=dev))

    def demo_at(t: float, sky=milky, cfg=full):
        return posed(demo_scene(sky, cfg.width, cfg.height,
                                dtype=torch.float32, device=dev), t)

    def many_at(t: float, cfg=full):
        return posed(many_sphere_scene(milky, N_SPHERES, cfg.width,
                                       cfg.height, dtype=torch.float32,
                                       device=dev), t)

    def frame(fb, cfg) -> np.ndarray:
        out = fb.to_array().cpu().numpy()
        assert out.shape == (cfg.height, cfg.width, 3), out.shape
        assert np.isfinite(out).all()
        return out

    # -- phase S1: the demo kernel under an image sky vs its plain version --
    big = assets.skybox_from_faces(assets.make_starfield_skybox(1024),
                                   device=dev)
    cases = [(0.0, milky, {}), (1.5, milky, {}), (7.3, milky, {}),
             (1.5, milky, {"skybox_bilinear": True}), (1.5, big, {})]
    demo_err = 0.0
    for t, sky, flags in cases:
        scene = demo_at(t, sky)
        cfg = full.with_(**flags)
        fb_k, rays_k = render.render_frame_cuda(scene, cfg)
        fb_p, rays_p = render.render_frame_plain(scene, cfg)
        torch.cuda.synchronize()
        stats = exact_bar(frame(fb_p, cfg), frame(fb_k, cfg), rays_p, rays_k)
        # the kernel mirrors its plain version op for op: bit for bit
        assert stats["max_abs"] == 0.0 and stats["diff_px"] == 0, stats
        demo_err = max(demo_err, stats["max_abs"])
        print(f"phase S1: starfield dim {sky.dim} t={t} {flags or ''} "
              f"{json.dumps(stats)}")
    del big

    # -- phase S2: the fused kernel under an image sky vs its plain version -
    small = full.with_(width=240, height=140, skybox_bilinear=True)
    fused_err = 0.0
    for cfg in (full, small):
        scene = many_at(fused_work["t"], cfg)
        t0 = time.perf_counter()
        fb_k, rays_k = fused_cuda(scene, cfg)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fb_p, rays_p = fused_plain(scene, cfg)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        stats = exact_bar(frame(fb_p, cfg), frame(fb_k, cfg), rays_p, rays_k)
        assert stats["max_abs"] == 0.0 and stats["diff_px"] == 0, stats
        fused_err = max(fused_err, stats["max_abs"])
        if cfg is full:
            # the sky changes no geometry: phase D's frame, traced again
            assert int(rays_k) == fused_work["rays"], (rays_k, fused_work)
            fused_plain_ms = 1e3 * (t2 - t1)
        print(f"phase S2: milky_way t={fused_work['t']} {cfg.width}x"
              f"{cfg.height} bilinear={cfg.skybox_bilinear} "
              f"{json.dumps(stats)} (kernel {t1 - t0:.3f} s, plain "
              f"{t2 - t1:.3f} s, host clock)")

    # -- phase S3: both kernels vs the stored JAX oracle ---------------------
    for stats in check_sky_golden(render.render_frame_cuda,
                                  mesh_fused.render_frame_mesh_fused, dev):
        print(f"phase S3: golden {json.dumps(stats)}")
    torch.cuda.synchronize()

    # -- phase S4: timing, and the main paths under milky_way ----------------
    scene = demo_at(1.5)
    demo_ms = {}
    for bilinear in (False, True):
        cfg = full.with_(skybox_bilinear=bilinear)
        _, rays = render.render_frame_cuda(scene, cfg)
        run = lambda: render.render_frame_cuda(scene, cfg,  # noqa: E731
                                               count_rays=False)
        demo_ms[bilinear] = (_median_ms(run),
                             _kernel_ms(run, "render_kernel"))
        print(f"phase S4 [{card}]: demo, milky_way, bilinear={bilinear}, "
              f"480x280x10spp, 10 bounces: {int(rays)} traces; wrapper "
              f"{demo_ms[bilinear][0]:.4f} ms (CUDA events, median of 20), "
              f"kernel alone {demo_ms[bilinear][1]:.4f} ms (torch.profiler, "
              f"mean of 20)")
    demo_rays = int(render.render_frame_cuda(scene, full)[1])
    demo_plain_ms = _median_ms(
        lambda: render.render_frame_plain(scene, full, count_rays=False),
        reps=5, warmup=1)
    many = many_at(fused_work["t"])
    fused_ms = _median_ms(lambda: fused_cuda(many, full))
    fused_kernel_ms = _kernel_ms(lambda: fused_cuda(many, full),
                                 "mesh_fused_kernel", reps=5)
    print(f"phase S4 [{card}]: fused, milky_way, t={fused_work['t']}: "
          f"wrapper {fused_ms:.4f} ms (median of 20), kernel alone "
          f"{fused_kernel_ms:.4f} ms (mean of 5), plain version "
          f"{fused_plain_ms:.3f} ms (phase S2, host clock); demo plain "
          f"version {demo_plain_ms:.3f} ms (median of 5)")

    # --skybox <dir>: six seeded random faces of another dim, read from PPM
    faces_dir = tempfile.TemporaryDirectory()
    rng = np.random.default_rng(4)
    for face in assets.FACE_NAMES:
        assets.write_ppm(os.path.join(faces_dir.name, f"{face}.ppm"),
                         rng.integers(0, 256, (FACE_DIM, FACE_DIM, 3),
                                      dtype=np.uint8))
    faces = faces_dir.name
    bilinear = unpaced.with_(skybox_bilinear=True)
    counters = (render.render_frame_cuda, render.render_frame_plain,
                fused_cuda, fused_plain, pathtrace.pathtrace_frame_cuda,
                pathtrace.pathtrace_frame_plain, render.sky_weights_cuda,
                render.sky_weights_plain, render.render_frame_pixel_rate_cuda,
                render.render_frame_pixel_rate_plain)
    launches = {}
    for name, sky, cfg, frames, kw in (
            ("demo", "milky_way", unpaced, N_FRAMES, {"device": dev}),
            ("many", "milky_way", unpaced, MESH_FRAMES,
             {"scene": many_at(0.0)}),
            ("pathtrace", "milky_way", unpaced, 1,
             {"device": dev, "pathtrace": True}),
            ("faces", faces, bilinear, FACE_FRAMES, {"device": dev}),
            ("faces many", faces, bilinear, FACE_FRAMES,
             {"scene": app.make_scene("many", bilinear, faces, device=dev,
                                      n_spheres=N_SPHERES)})):
        sink = io.BytesIO()
        timers = StageTimers()
        for fn in counters:
            fn.launches = 0
        t0 = time.perf_counter()
        app.run_animation(cfg, sky, max_frames=frames, interactive=False,
                          encode="device", stream=sink, timers=timers, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[name] = [fn.launches for fn in counters]
        validate_stream(sink.getvalue(), full.width, full.height, frames)
        split = {k: round(st["mean_ms"], 4)
                 for k, st in timers.summary().items()}
        label = "milky_way" if sky == "milky_way" else (
            f"<dir of six {FACE_DIM}-texel faces> --bilinear")
        print(f"phase S4 [{card}]: --skybox {label}, {name}: {frames} "
              f"frames in {wall:.3f} s = {frames / wall:.2f} fps end to end "
              f"(pacing off), stage means (ms) {json.dumps(split)}; launches "
              f"render {launches[name][:2]}, fused {launches[name][2:4]}, "
              f"pathtrace {launches[name][4:6]}, sky weights "
              f"{launches[name][6:8]}, pixel rate {launches[name][8:]} "
              f"(kernel, plain)")
    faces_dir.cleanup()
    assert launches["demo"] == [N_FRAMES] + [0] * 9, launches
    assert launches["many"] == [0, 0, MESH_FRAMES] + [0] * 7, launches
    assert launches["pathtrace"] == [0] * 10, launches
    assert launches["faces"] == [FACE_FRAMES] + [0] * 9, launches
    assert launches["faces many"] == [0, 0, FACE_FRAMES] + [0] * 7, launches
    # each kernel's launches over the main paths under an image sky
    path_launches = [sum(col) for col in zip(*launches.values())]

    # -- phase S5: the sky-weight kernel -------------------------------------
    sw_cuda, sw_plain = render.sky_weights_cuda, render.sky_weights_plain
    sw_cuda.launches = sw_plain.launches = 0
    w_k = render.sky_weights(scene, full)
    sw_launches = [sw_cuda.launches, sw_plain.launches]
    assert sw_launches == [1, 0], sw_launches
    w_p = sw_plain(scene, full)
    torch.cuda.synchronize()
    assert w_k.shape == (full.rays_per_pixel, full.height, full.width)
    sw_err = float((w_k - w_p).abs().max())
    sw_diff = int((w_k != w_p).sum())
    assert sw_diff == 0, (sw_diff, sw_err)
    # its bound: every nearest-hit trace tests the 6 spheres and the plane;
    # the traces counted on the plain chain (no shadow rays)
    chain, _ = render._demo_chain(scene, full, shade=False)
    nearest = int((chain[5] & 0x1F).sum())
    sw_bound = bound_ms(
        nearest * (PT_TRACE_OPS + 6 * PT_TRACE_SPHERE_OPS),
        4 * (17 + 9 * 6 + 16 + 6 + 7) + 4 * w_k.numel())
    sw_ms = _median_ms(lambda: render.sky_weights_cuda(scene, full))
    sw_kernel_ms = _kernel_ms(lambda: render.sky_weights_cuda(scene, full),
                              "sky_weight_kernel")
    sw_plain_ms = _median_ms(lambda: sw_plain(scene, full), reps=5,
                             warmup=1)
    print(f"phase S5 [{card}]: sky weights, 480x280x10, 10 bounces, t=1.5: "
          f"{w_k.numel()} rays, {nearest} nearest-hit traces, {sw_diff} "
          f"differ from the plain version (max |d| {sw_err}); wrapper "
          f"{sw_ms:.4f} ms (median of 20), kernel alone {sw_kernel_ms:.4f} "
          f"ms (mean of 20), plain version {sw_plain_ms:.3f} ms (median of "
          f"5); bound {sw_bound[0]:.4f} ms by {sw_bound[1]}; launches "
          f"(kernel, plain) in this phase's call {sw_launches}")

    # -- phase S6: the pixel-rate kernel -------------------------------------
    pr_cuda = render.render_frame_pixel_rate_cuda
    pr_plain = render.render_frame_pixel_rate_plain
    rate_err = 0.0
    for sky, t, flags in (("colors", 1.5, {}),
                          ("uv_checker", 1.5, {"skybox_bilinear": True,
                                               "specular": True})):
        s6 = demo_at(t, assets.load_skybox(sky, device=dev))
        cfg = full.with_(**flags)
        pr_cuda.launches = pr_plain.launches = 0
        fb_k, rays_k = render.render_frame_pixel_rate(s6, cfg)
        rate_launches = [pr_cuda.launches, pr_plain.launches]
        assert rate_launches == [1, 0], rate_launches
        fb_p, rays_p = pr_plain(s6, cfg)
        fb_f, rays_f = render.render_frame_cuda(s6, cfg)
        torch.cuda.synchronize()
        out = frame(fb_k, cfg)
        stats = exact_bar(frame(fb_p, cfg), out, rays_p, rays_k)
        same = exact_bar(frame(fb_f, cfg), out, rays_f, rays_k)
        assert stats["max_abs"] == 0.0 and same["max_abs"] == 0.0, (
            stats, same)
        rate_err = max(rate_err, stats["max_abs"])
        print(f"phase S6: pixel rate, {sky} t={t} {flags or ''}: vs plain "
              f"{json.dumps(stats)}, vs render_frame_cuda max |d| "
              f"{same['max_abs']}, traces {int(rays_f)}")
        if sky == "colors":
            rate_rays = int(rays_k)
            rate_ms = _median_ms(lambda: pr_cuda(s6, cfg))
            rate_kernel_ms = _kernel_ms(lambda: pr_cuda(s6, cfg),
                                        "render_kernel")
            rate_plain_ms = _median_ms(lambda: pr_plain(s6, cfg), reps=5,
                                       warmup=1)
    rate_bound = demo_bound(rate_rays, n_px)
    print(f"phase S6 [{card}]: pixel rate, colors t=1.5: wrapper "
          f"{rate_ms:.4f} ms (median of 20), kernel alone "
          f"{rate_kernel_ms:.4f} ms (mean of 20), plain version "
          f"{rate_plain_ms:.3f} ms (median of 5); bound {rate_bound[0]:.4f} "
          f"ms by {rate_bound[1]}; launches (kernel, plain) in this phase's "
          f"call {rate_launches}")

    demo_bound_img = demo_bound(demo_rays, n_px, texel_bytes)
    fused_bound = bound_ms(fused_work["ops"],
                           fused_work["bytes"] + texel_bytes)
    print(f"phase S4-S6 [{card}]: bounds: textured demo "
          f"{demo_bound_img[0]:.4f} ms by {demo_bound_img[1]} ({demo_rays} "
          f"traces, {texel_bytes} bytes of texels), textured fused "
          f"{fused_bound[0]:.4f} ms by {fused_bound[1]}")
    def entry(**kw) -> dict:
        # no single PyTorch call renders a frame or a sky-weight map
        return {"route": "cuda", "library_ms": None, **kw}

    return [
        entry(name="render_image_sky",
              source="ttrt_torch/kernels/csrc/render.cu",
              replaces="ttrt/kernels/render_pallas.py:989",
              launches=path_launches[0], max_abs_err=demo_err,
              ms=demo_ms[False][0], plain_ms=demo_plain_ms,
              bound_ms=demo_bound_img[0], bound_by=demo_bound_img[1]),
        entry(name="mesh_fused_image_sky",
              source="ttrt_torch/kernels/csrc/mesh.cu",
              replaces="ttrt/kernels/mesh_fused.py:1133",
              launches=path_launches[2], max_abs_err=fused_err,
              ms=fused_ms, plain_ms=fused_plain_ms,
              bound_ms=fused_bound[0], bound_by=fused_bound[1]),
        entry(name="sky_weights",
              source="ttrt_torch/kernels/csrc/render.cu",
              replaces="ttrt/kernels/render_pallas.py:860",
              launches=path_launches[6], max_abs_err=sw_err, ms=sw_ms,
              plain_ms=sw_plain_ms, bound_ms=sw_bound[0],
              bound_by=sw_bound[1]),
        entry(name="render_pixel_rate",
              source="ttrt_torch/kernels/csrc/render.cu",
              replaces="ttrt/kernels/render_pallas.py:612",
              launches=path_launches[8], max_abs_err=rate_err, ms=rate_ms,
              plain_ms=rate_plain_ms, bound_ms=rate_bound[0],
              bound_by=rate_bound[1]),
    ]


def sum_bound(n: int) -> float:
    """The largest |d| between a frame whose N-sample sums were added in
    slices and the in-order one: each order is within (N - 1) u N of the
    exact sum of N samples <= 1 (u = 2^-24), and the 1/N scaling adds at
    most u, so |d| <= 2 (N - 1) u + 2 u = N 2^-23."""
    return n * 2.0 ** -23


def mesh_axis_phases(card: str, dev, full) -> list:
    """Phases M0-M5; returns the kernels line's entries of the band launch
    of the demo kernel, the path-tracing kernel's sum mode and
    cluster_nearest on objects shards."""
    import torch

    from ttrt_torch import app, assets
    from ttrt_torch.frames import orbit_camera_frame
    from ttrt_torch.kernels import mesh, mesh_fused, pathtrace, render
    from ttrt_torch.mesh.scene import many_sphere_scene
    from ttrt_torch.parallel import objects, sharding
    from ttrt_torch.render import pathtrace as estimator
    from ttrt_torch.render.integrator import generate_rays
    from ttrt_torch.scene import demo_scene
    from ttrt_torch.utils.profiling import StageTimers
    from ttrt_torch.vec import Vec3

    t_start = time.perf_counter()
    lights = estimator.default_area_lights(full, dev)
    n_px = full.width * full.height

    def demo_at(sky: str, t: float, cfg=full):
        scene = demo_scene(assets.load_skybox(sky, device=dev), cfg.width,
                           cfg.height, dtype=torch.float32, device=dev)
        return scene.with_camera_frame(
            orbit_camera_frame(t, dtype=torch.float32, device=dev))

    def same(ref, out, label) -> dict:
        ref = ref.to_array().cpu().numpy()
        out = out.to_array().cpu().numpy()
        assert np.isfinite(out).all(), label
        d = np.abs(ref.astype(np.float64) - out)
        return {"max_abs": float(d.max()),
                "diff_px": int((d > 0).any(axis=-1).sum())}

    # -- phase M0: any sphere and light count --------------------------------
    small = full.with_(width=64, height=32, rays_per_pixel=2, bounce_limit=3)
    for label, cfg, scene in (
            ("70 spheres, 9 + 9 lights (shared memory)", full,
             crowd(demo_at("colors", 1.5), 70, 9, 9, seed=3)),
            ("1400 spheres, 1 + 1 lights (global memory)", small,
             crowd(demo_at("colors", 1.5, small), 1400, 1, 1, seed=4))):
        fb_k, rays_k = render.render_frame_cuda(scene, cfg)
        fb_p, rays_p = render.render_frame_plain(scene, cfg)
        stats = same(fb_p, fb_k, label)
        stats["rays"], stats["rays_ref"] = int(rays_k), int(rays_p)
        seed = pathtrace.frame_seed(0, 1.5)
        pt_k, work_k = pathtrace.pathtrace_frame_cuda(scene, lights, cfg,
                                                      seed)
        pt_p, work_p = pathtrace.pathtrace_frame_plain(scene, lights, cfg,
                                                       seed)
        stats["pathtrace"] = same(pt_p, pt_k, label)
        stats["work"] = [int(v) for v in work_k]
        stats["work_ref"] = [int(v) for v in work_p]
        torch.cuda.synchronize()
        print(f"phase M0: {label}, {cfg.width}x{cfg.height}x"
              f"{cfg.rays_per_pixel}: {json.dumps(stats)}")
        assert stats["max_abs"] == 0.0 and stats["rays"] == stats["rays_ref"]
        assert stats["pathtrace"]["max_abs"] == 0.0, stats
        assert stats["work"] == stats["work_ref"], stats

    # the fused kernel's camera and lights: 9 + 9 lights
    lit = crowd(many_sphere_scene(assets.load_skybox("colors", device=dev),
                                  2240, small.width, small.height,
                                  dtype=torch.float32, device=dev), 0, 9, 9,
                seed=5)
    fb_k, rays_k = mesh_fused.render_band_mesh_fused_cuda(lit, small)
    fb_p, rays_p = mesh_fused.render_band_mesh_fused_plain(lit, small)
    stats = same(fb_p, fb_k, "fused, 9 + 9 lights")
    stats["rays"], stats["rays_ref"] = int(rays_k), int(rays_p)
    print(f"phase M0: fused kernel, 2240 spheres, 9 + 9 lights, "
          f"{small.width}x{small.height}x{small.rays_per_pixel}: "
          f"{json.dumps(stats)}")
    assert stats["max_abs"] == 0.0 and stats["rays"] == stats["rays_ref"]

    # -- phase M1: the demo kernel's bands -----------------------------------
    band_err = 0.0
    for sky, flags in (("colors", {}), ("milky_way",
                                        {"skybox_bilinear": True})):
        cfg = full.with_(**flags)
        scene = demo_at(sky, 1.5)
        whole, rays = render.render_frame_cuda(scene, cfg)
        for n_i, n_j in ((4, 1), (2, 2), (1, 2)):
            parts, total = {}, 0
            for i in range(n_i):
                for j in range(n_j):
                    b = sharding.band_at(cfg, n_i, n_j, i, j)
                    fb, count = render.render_band_cuda(
                        scene, cfg, b.row_offset, b.n_rows,
                        sample_offset=b.sample_offset, n_samples=b.n_samples,
                        reduce="sum")
                    parts[(i, j)] = fb
                    total += int(count)
            stats = same(whole, sharding.combine_bands(parts, cfg),
                         (sky, n_i, n_j))
            stats.update(traces=total, traces_whole=int(rays),
                         bound=sum_bound(cfg.rays_per_pixel))
            print(f"phase M1: {sky} {flags or ''} {n_i}x{n_j} bands "
                  f"combined vs render_frame_cuda: {json.dumps(stats)}")
            assert total == int(rays), stats
            if n_j == 1:
                assert stats["max_abs"] == 0.0, stats
            assert stats["max_abs"] <= stats["bound"], stats
        # one band x slice against its plain version
        b = sharding.band_at(cfg, 2, 2, 1, 1)
        kw = dict(sample_offset=b.sample_offset, n_samples=b.n_samples,
                  reduce="sum")
        fb_k, c_k = render.render_band_cuda(scene, cfg, b.row_offset,
                                            b.n_rows, **kw)
        fb_p, c_p = render.render_band_plain(scene, cfg, b.row_offset,
                                             b.n_rows, **kw)
        stats = same(fb_p, fb_k, "band (1, 1)")
        band_err = max(band_err, stats["max_abs"])
        print(f"phase M1: {sky} band (1, 1) of 2x2, kernel vs plain: "
              f"{json.dumps(stats)}, traces {int(c_k)} / {int(c_p)}")
        assert stats["max_abs"] == 0.0 and int(c_k) == int(c_p), stats
    # the band launch of a one-rank mesh: the whole frame, samples summed
    scene = demo_at("colors", 1.5)
    _, band_rays = render.render_band_cuda(scene, full, reduce="sum")
    run = lambda: render.render_band_cuda(  # noqa: E731
        scene, full, reduce="sum", count_rays=False)
    band_ms, band_kernel_ms = _median_ms(run), _kernel_ms(run, "render_kernel")
    band_plain_ms = _median_ms(lambda: render.render_band_plain(
        scene, full, reduce="sum", count_rays=False), reps=3, warmup=1)
    frame_kernel_ms = _kernel_ms(
        lambda: render.render_frame_cuda(scene, full, count_rays=False),
        "render_kernel")
    band_bound = demo_bound(int(band_rays), n_px)
    print(f"phase M1 [{card}]: the whole-frame sum band, colors t=1.5: "
          f"wrapper {band_ms:.4f} ms (median of 20), kernel alone "
          f"{band_kernel_ms:.4f} ms (mean of 20), the average "
          f"(render_frame_cuda) alone {frame_kernel_ms:.4f} ms, plain "
          f"{band_plain_ms:.3f} ms; bound {band_bound[0]:.4f} ms by "
          f"{band_bound[1]}")

    # -- phase M2: the path tracer's sum mode --------------------------------
    seed = pathtrace.frame_seed(0, 0.7)
    scene = demo_at("colors", 0.7)
    fb_k, work_k = pathtrace.pathtrace_frame_cuda(scene, lights, full, seed,
                                                  reduce="sum")
    fb_p, work_p = pathtrace.pathtrace_frame_plain(scene, lights, full, seed,
                                                   reduce="sum")
    stats = same(fb_p, fb_k, "sum")
    sum_err = stats["max_abs"]
    stats["max"] = float(fb_k.to_array().max())
    print(f"phase M2: path tracer, sum mode, kernel vs plain: "
          f"{json.dumps(stats)}")
    assert stats["max_abs"] == 0.0, stats
    assert [int(v) for v in work_k] == [int(v) for v in work_p]
    cfg12 = full.with_(rays_per_pixel=12)
    single, _ = pathtrace.pathtrace_frame_cuda(scene, lights, cfg12, seed)
    parts = [pathtrace.pathtrace_frame_cuda(
        scene, lights, cfg12.with_(rays_per_pixel=3),
        sharding.device_seed(seed, idx), count_rays=False, reduce="sum")[0]
        for idx in range(4)]
    combined = sharding.combine_pathtrace(parts, cfg12)
    gap = float(combined.to_array().mean() - single.to_array().mean())
    print(f"phase M2: 4 device streams at 3 spp each, combined, vs one "
          f"12-spp frame: image means differ by {gap:.6f}")
    assert abs(gap) < PT_ESTIMATOR_MEAN_TOL, gap
    pt_run = lambda: pathtrace.pathtrace_frame_cuda(  # noqa: E731
        scene, lights, full, seed, count_rays=False, reduce="sum")
    pt_ms, pt_kernel_ms = _median_ms(pt_run), _kernel_ms(pt_run,
                                                         "pathtrace_kernel")
    pt_mean_kernel_ms = _kernel_ms(
        lambda: pathtrace.pathtrace_frame_cuda(scene, lights, full, seed,
                                               count_rays=False),
        "pathtrace_kernel")
    pt_plain_ms = _median_ms(lambda: pathtrace.pathtrace_frame_plain(
        scene, lights, full, seed, count_rays=False, reduce="sum"), reps=3,
        warmup=1)
    pt_bound = bound_ms(
        pathtrace_ops(work_k, scene.spheres.count, lights.count,
                      n_px * full.rays_per_pixel),
        4 * (17 + 9 * scene.spheres.count + 16 + 8 * lights.count)
        + 20 * n_px)
    print(f"phase M2 [{card}]: sum mode wrapper {pt_ms:.4f} ms (median of "
          f"20), kernel alone {pt_kernel_ms:.4f} ms, the mean mode alone "
          f"{pt_mean_kernel_ms:.4f} ms (means of 20), plain "
          f"{pt_plain_ms:.3f} ms; bound {pt_bound[0]:.4f} ms by "
          f"{pt_bound[1]}")

    # -- phase M3: the fused kernel's bands ----------------------------------
    many = many_sphere_scene(assets.load_skybox("colors", device=dev),
                             N_SPHERES, full.width, full.height,
                             dtype=torch.float32, device=dev)
    many = many.with_camera_frame(
        orbit_camera_frame(3.3, dtype=torch.float32, device=dev))
    whole, rays = mesh_fused.render_band_mesh_fused_cuda(many, full)
    parts, total = {}, 0
    for i in range(2):
        for j in range(2):
            b = sharding.band_at(full, 2, 2, i, j)
            fb, count = mesh_fused.render_band_mesh_fused_cuda(
                many, full, b.row_offset, b.n_rows,
                sample_offset=b.sample_offset, n_samples=b.n_samples,
                reduce="sum")
            parts[(i, j)] = fb
            total += int(count)
    stats = same(whole, sharding.combine_bands(parts, full), "fused 2x2")
    stats.update(traces=total, traces_whole=int(rays),
                 bound=sum_bound(full.rays_per_pixel))
    print(f"phase M3: fused kernel, {N_SPHERES} spheres, t=3.3, 2x2 bands "
          f"combined vs the whole frame: {json.dumps(stats)}")
    assert total == int(rays) and stats["max_abs"] <= stats["bound"], stats

    # -- phase M4: cluster_nearest on objects shards -------------------------
    o, d = generate_rays(many, full)
    o = Vec3(*(c.contiguous() for c in o))
    whole_hit = mesh.cluster_nearest_cuda(many.clusters, o, d)
    shard_err = 0.0
    for n in (2, 4):
        padded = objects.pad_pack_subclusters(many.clusters.tables, n)
        shards = [objects.shard_tables(padded, n, k) for k in range(n)]
        merged = objects.merge_nearest(
            [mesh.cluster_nearest_cuda(sh, o, d) for sh in shards])
        stats = nearest_bar(whole_hit, merged)
        shard_err = max(shard_err, stats["max_abs_t"])
        print(f"phase M4: {n} shards of {padded.kb_sph} + {padded.kb_tri} "
              f"subclusters, merged vs the whole pack: {json.dumps(stats)}")
    quarter = shards[0]
    shard_ms = _median_ms(lambda: mesh.cluster_nearest_cuda(quarter, o, d))
    shard_plain_ms = _median_ms(
        lambda: mesh.cluster_nearest_plain(quarter, o, d), reps=1, warmup=0)
    n_rays = o.x.numel()
    shard_bytes = sum(v.numel() * v.element_size() for v in quarter
                      if isinstance(v, torch.Tensor))
    lo, hi = (quarter.qbox[:, :3], quarter.qbox[:, 3:6])
    keep = quarter.qbox[:, 6] > 0
    n_obj = quarter.qbox[keep, 6]
    is_tri = (torch.arange(quarter.qbox.shape[0], device=dev)
              >= 4 * quarter.kb_sph)[keep]
    boxes = (lo[keep], hi[keep], n_obj,
             n_obj * torch.where(is_tri, float(TRI_OPS), float(SPHERE_OPS)))
    t_shard = mesh.cluster_nearest_cuda(quarter, o, d).t
    shard_objs, shard_ops = narrow_work(boxes, o, d, t_shard)
    shard_bound = bound_ms(
        n_rays * int(keep.sum()) * SLAB_OPS + float(shard_ops),
        shard_bytes + 32 * n_rays)
    print(f"phase M4 [{card}]: cluster_nearest on shard 0 of 4 "
          f"({int(keep.sum())} quarters), {n_rays} primary rays: "
          f"{shard_ms:.4f} ms (median of 20), plain {shard_plain_ms:.3f} ms; "
          f"bound {shard_bound[0]:.4f} ms by {shard_bound[1]} "
          f"({float(shard_objs) / n_rays:.2f} narrow tests a ray)")
    torch.cuda.synchronize()
    print(f"phases M0-M4: {time.perf_counter() - t_start:.1f} s")

    # -- phase M5: --mesh on the card, a one-rank NCCL group -----------------
    unpaced = full.with_(frame_rate=1e9)
    counters = (render.render_band_cuda, render.render_band_plain,
                render.render_frame_cuda, render.render_frame_plain,
                pathtrace.pathtrace_frame_cuda,
                pathtrace.pathtrace_frame_plain,
                mesh_fused.render_band_mesh_fused_cuda,
                mesh_fused.render_band_mesh_fused_plain,
                mesh.cluster_nearest_cuda, mesh.cluster_nearest_plain)
    launches = {}
    many0 = many.with_camera_frame(
        orbit_camera_frame(0.0, dtype=torch.float32, device=dev))
    for name, spec, frames, kw in (
            ("demo", "auto", N_FRAMES, {"device": dev}),
            ("pathtrace", "auto", 10, {"device": dev, "pathtrace": True}),
            ("many", "auto", 5, {"scene": many0}),
            ("objects", "1x1x1", 2, {"scene": many0})):
        sink = io.BytesIO()
        timers = StageTimers()
        for fn in counters:
            fn.launches = 0
        t0 = time.perf_counter()
        app.run_animation(unpaced, "colors", max_frames=frames,
                          interactive=False, encode="device", stream=sink,
                          timers=timers, mesh_spec=spec, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        assert not torch.distributed.is_initialized()
        launches[name] = [fn.launches for fn in counters]
        validate_stream(sink.getvalue(), full.width, full.height, frames)
        split = {k: [round(st["mean_ms"], 4), round(st["p50_ms"], 4)]
                 for k, st in timers.summary().items()}
        print(f"phase M5 [{card}]: --mesh {spec} ({name}), one NCCL rank: "
              f"{frames} frames in {wall:.3f} s = {frames / wall:.2f} fps "
              f"end to end (pacing off, process group set-up included), "
              f"stage [mean, median] (ms) {json.dumps(split)}; launches "
              f"(kernel, "
              f"plain): band {launches[name][0:2]}, frame "
              f"{launches[name][2:4]}, pathtrace {launches[name][4:6]}, "
              f"fused {launches[name][6:8]}, cluster_nearest "
              f"{launches[name][8:10]}")
    z = [0, 0]
    assert launches["demo"] == [N_FRAMES, 0] + z * 4, launches
    assert launches["pathtrace"] == z * 2 + [10, 0] + z * 2, launches
    assert launches["many"] == z * 3 + [5, 0] + z, launches
    assert launches["objects"][:8] == [0] * 8, launches
    assert launches["objects"][8] > 0 and launches["objects"][9] == 0, (
        launches)
    print(f"phases M0-M5: {time.perf_counter() - t_start:.1f} s")

    def entry(**kw) -> dict:
        # no single PyTorch call renders a band or finds a nearest hit
        return {"route": "cuda", "library_ms": None, **kw}

    return [
        entry(name="render_band", source="ttrt_torch/kernels/csrc/render.cu",
              replaces="ttrt/kernels/render_pallas.py:1357",
              launches=launches["demo"][0], max_abs_err=band_err,
              ms=band_ms, plain_ms=band_plain_ms, bound_ms=band_bound[0],
              bound_by=band_bound[1]),
        entry(name="pathtrace_sum",
              source="ttrt_torch/kernels/csrc/pathtrace.cu",
              replaces="ttrt/kernels/pathtrace_pallas.py:372",
              launches=launches["pathtrace"][4], max_abs_err=sum_err,
              ms=pt_ms, plain_ms=pt_plain_ms, bound_ms=pt_bound[0],
              bound_by=pt_bound[1]),
        entry(name="cluster_nearest_objects_shard",
              source="ttrt_torch/kernels/csrc/mesh.cu",
              replaces="ttrt/parallel/objects.py:152",
              launches=launches["objects"][8], max_abs_err=shard_err,
              ms=shard_ms, plain_ms=shard_plain_ms,
              bound_ms=shard_bound[0], bound_by=shard_bound[1]),
    ]


if __name__ == "__main__":
    sys.exit(main())
