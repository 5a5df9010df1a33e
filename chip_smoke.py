"""Smoke run of the PyTorch/CUDA port (ttrt_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py [--parent DIR]

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
     within max(0.5%, 16). Then RENDER_CASES at reduced sizes, bit for
     bit: an odd frame, a band of rows x a sample slice, 33 samples (two
     rounds of sample threads), a 1400-sphere scene read in place, and
     the pixel-rate frame in rounds and in place: every instantiation the
     launch can choose.
  3. kernel vs the JAX oracle stored in tests/data/torch_port_golden.npz:
     zero u8 flips outside the stored knife-edge classes K1 | K2 and the
     quantization class KQ (tests/knife_util.py's bar).
  4. timing with CUDA events (median of 20 after warm-up): the kernel's
     wrapper (scene packing included) and the plain version at the full
     config, the device ANSI encode, the copy to the host and the write;
     the kernel's own device time from torch.profiler (each such line
     says how its time was taken: when the profiler gives no row for the
     kernel, it is the wrapper's by CUDA events and the line says so);
     its launch shape (blocks, threads, waves, registers) and ptxas lines.
  5. 60 frames of ttrt_torch.app.run_animation into a byte sink, pacing
     off: the ANSI stream is validated, the kernel's launch count must rise
     by 60 and the plain version's must not move.

The host runtime (ttrt_torch/native/, --encode auto, --batch, --profile,
--debug-nans) and the many-object scene's grid and with_spheres, every
frame on the kernels above:

  RT. the native library built from csrc/ttrt_native.c into
      ttrt_torch/_build/ and --encode auto resolving to host; demo frames
      at t = 0.0, 1.5, 3.3 encoded three ways (the native encoder on the
      copied RGB frame, encode_ansi_frame on the card, encode_ansi_host),
      byte for byte; build_frame_batch_step(batch=8) at t0 = 1.5 against
      build_frame_step(encode='host') at t0 + k/fps, bit for bit; 60
      frames each of --encode device, --encode host and --batch 8 in
      turns, 3 rounds, pacing off (host clock: fps and the StageTimers
      split of the median round; the first round's streams validated;
      the render launches counted with the counts set to 0 before), the native encode alone
      and the RGB copy alone (host clock, medians of 20); python -m
      ttrt_torch --frames 5 --profile DIR, with --encode auto and device
      (two processes at once): the trace's CUDA kernels a frame and
      render_kernel once a frame; 60 frames with --debug-nans and without,
      in turns, twice each, and the check alone (host clock); many_sphere_scene's
      build at 10k and 100k spheres with the grid (host clock); a 10k
      scene moved by a seeded offset through with_spheres on the card: its
      rebuilt pack byte for byte against a fresh pack_clusters,
      cluster_nearest_cuda against the dense tester on 4,096 of its
      primary rays (ids equal, t bit for bit), and its main paths (5
      frames fused, 1 eager), the launch counts set to 0 before and read
      after. Each section's end is printed in seconds from the phase's
      start (host clock).

The many-object scene (10k spheres over a 512-triangle floor), through the
fused kernel and the cluster-culled nearest-hit kernel (csrc/mesh.cu):

  A. the fused kernel vs its plain version, both on the card, at 480x280,
     10 spp, 10 bounces: the 'colors' sky at t = 0.7 and 3.3 and one
     frame each with --specular, --energy-model subtract and --bilinear
     ('uv_checker'). Bar: the
     phase-2 bar and equal trace counts; max |d| and the differing pixels
     are printed (they are expected to be 0). Then FUSED_CASES at reduced
     sizes, bit for bit: bands of rows and sample slices (1, 3, 5 of 10
     samples, summed or averaged), sides that are no multiple of a block,
     33 samples (two rounds of sample threads), --specular, subtract, the
     milky_way sky bilinear, 240,000 spheres at 2 and 33 samples and 3
     rows of the 100,000-sphere frame (trees 16 and 15 levels deep), and
     SCENE_FILE's nine spheres over the floor: every instantiation the
     launch can choose.
  B. cluster_nearest ("cull" and "dense") vs the dense tester on the
     frame's primary rays and on one bounce's rays; vs cluster_nearest_plain
     on three batches of the eager frame (eager_batches: the primary rays,
     bounce 3's rays and the point light's first shadow rays, full length,
     dead rays included); on a 240,000-sphere pack: t bit-equal, ids equal.
  C. the fused kernel vs the JAX oracle stored in
     tests/data/torch_port_golden_mesh.npz, with phase 3's bar.
  D. timing with CUDA events: the fused kernel alone and with its wrapper
     (packing), the plain version, the kernel alone and
     with its wrapper at 100k spheres, and cluster_nearest's wrapper on the
     primary rays and the kernel alone on phase B's three batches; each
     kernel's bound, from the narrow tests its traces need (for the fused
     kernel, every trace of the frame, counted on one more run of the
     plain version, with the flat sweep's slab tests; for cluster_nearest
     each batch's, beside the narrow
     tests its index-order walk really makes and the walk's SIMT
     efficiency, walk_work); cluster_nearest's launch shape and ptxas
     lines; the fused kernel's launch shape at 10k and 100k
     spheres (blocks, threads, waves, registers) and its ptxas lines;
     walk_work on the fused frame's primary, bounce-3 and shadow rays
     (fused_batches, from one more run of the plain version): slab and
     narrow tests a trace and their SIMT efficiency, the flat sweep in
     the frame's visit order against the tree walk, the same hits and
     blockers; the
     10k frame as ten one-sample sum bands launched together on ten
     streams against the one launch (well under 1 would say the one
     launch leaves the card idle) and one one-sample band alone. With
     --parent DIR (a parent checkout): the parent's fused kernel and
     this one's alone in turns at 10k and 100k spheres, their frames
     bit for bit equal, and the ptxas lines of pathtrace_mesh_kernel
     and cluster_nearest_kernel equal to the parent's (parent_phase).
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
      differences are expected to be 0). Then PATHTRACE_CASES at reduced
      sizes, each in both reduce modes, bit for bit with equal work: an
      odd frame, 33 samples (two rounds of sample threads), a
      1400-sphere scene read in place, and both: with the full frames,
      every instantiation the launch can choose.
  P2. the kernel vs JAX's kernel stored in
      tests/data/torch_port_golden_pathtrace.npz (PATHTRACE_BAR).
  P3. timing: the wrapper (CUDA events, median of 20), the kernel alone
      (torch.profiler), the plain version; traces a frame and Mray/s from
      the plain version's count; the kernel's bound from the FP32
      operations its work needs (the PT_* counts); its launch shape
      (pathtrace_layout) and ptxas lines.
  P4. the main path: 30 frames of run_animation(..., pathtrace=True), the
      launch counts set to 0 before and read after, then one frame of the
      eager estimator on the card, whose image mean must be within 0.01 of
      the kernel's frame.

The many-object path tracer (--pathtrace --scene many), through
csrc/mesh.cu::pathtrace_mesh_kernel (pathtrace.cuh's estimator over the
fused kernel's walk), with the demo's area light:

  PM1. the kernel vs its plain version, both on the card: the full
       480x280x10spp, 10-bounce frame of the 10k-sphere scene at the
       frame seed of t = 0.7, 24 drawn rows of it against the plain
       version's same rows, bit for bit; then PATHTRACE_MESH_CASES at
       reduced sizes, each in both reduce modes, bit for bit with equal
       work: an odd frame, 33 samples (two rounds of sample threads), and
       240,000 spheres (the boxes read in place) at 2 and 33 samples:
       every instantiation the launch can choose.
  PM2. the kernel against the eager estimator (its own random stream,
       tracing through cluster_nearest) on the full frame: image means
       within PT_ESTIMATOR_MEAN_TOL.
  PM3. timing: the wrapper (CUDA events, median of 10), the kernel alone
       (torch.profiler); its work and traces a frame; its launch shape
       (pathtrace_layout) and the ptxas lines of its four
       instantiations.
  PM4. the main path: PM_FRAMES frames of run_animation(..., scene=many,
       pathtrace=True), the launch counts set to 0 before and read after:
       the kernel's rise by PM_FRAMES, the plain version's and
       cluster_nearest's stay 0, and profiling.PATH_STEPS counts every
       step on the kernel's route.

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
      bit; its time and bound, its launch shape (sky_weights_layout) and
      ptxas lines; then SKY_CASES, bit for bit: a ray count no multiple
      of a block, and a 1400-sphere scene read in place.
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

JSON scene files, the physics tier and banded stills (every frame on the
render and path-tracing kernels above):

  SF. a JSON scene file (SCENE_FILE: 9 spheres, two directional lights,
      no point light, the ground at y = -1) at 480x280x10x10 through
      render_frame_cuda under 'uv_checker' and 'milky_way' and through
      pathtrace_frame_cuda, each bit for bit with equal traces (work)
      against its plain version; their times and bounds; 60, 10 and 10
      frames of run_animation on the file's scene (the second under
      milky_way, the third --pathtrace), the launch counts set to 0
      before and read after; then the CLI, a process each: --scene-file F
      --still (the file equal to the kernel's frame), --scene-file F
      --frames 30 --no-input (the stream validated, the HUD's fps) and
      --show-skybox colors --width 30 (six colors of truecolor cells).
  PH. the physics tier, float32: 120 frames of the demo drop (4 substeps
      of 1/60 s) and 40 steps of two spheres head-on, each run twice on
      the card (equal bits) and once on the CPU (within PHYSICS_TOL), the
      head-on world's pair touching; the physics step kernel against the
      eager step on the card, every leaf of 120 drop frames bit for bit,
      and against benchmark/reference/physics.py's CPU step through frame
      8,000; the drop's frames 0, 30, ..., 120
      rendered by render_frame_cuda and render_frame_plain, bit for bit;
      the step's time through the kernel and the eager step, their ATen
      ops and CUDA kernels a frame, the kernel's launch and ptxas lines;
      60 frames of run_physics (the stage split, physics apart, every
      step through the kernel); python -m
      ttrt_torch --scene physics --frames 3 --checkpoint C twice, beside
      the step checks, the second resuming at the first's t.
  BT. render_frame_tiled in 4 bands against the whole eager frame at the
      full config (tests/test_tiled.py's bar), and render_still with
      --bands 4 --renderer eager writing that banded frame.

The bench (ttrt_torch/bench.py, every frame on the kernels above):

  BN. first each kernel the bench launches against its plain version at
      the bench's own shapes (bench_checks: each tier's config, scene,
      camera scale and first window time), bit for bit with equal traces;
      then every tier of the bench once (bench.run(repeats=1)): the line
      printed, every key of bench.LINE_KEYS finite and > 0, no
      <tier>_error; the launch counters set to 0 before and read after:
      every kernel's (render, fused, cluster_nearest, path tracer) > 0,
      every plain version's 0. The kernels line's launches add the
      bench's, not the checks'.

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
from typing import NamedTuple

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
PM_FRAMES = 10
PM_ROWS = 24  # rows of the full many-object frame held bit for bit
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


class FusedCase(NamedTuple):
    """A band of the many-object scene (t = 3.3) for the fused kernel
    against its plain version: ``config`` the RenderConfig's fields,
    ``band`` render_band_mesh_fused's row and sample arguments, ``rounds``
    whether a pixel's samples take more than one round of its sample
    threads (the two instantiations of mesh_fused_kernel), ``scene_file``
    whether the spheres are SCENE_FILE's nine in place of ``spheres``
    random ones (a tree of three leaves)."""

    key: str
    label: str
    spheres: int
    sky: str
    config: dict
    band: dict
    rounds: bool = False
    scene_file: bool = False


# The fused kernel's launch shapes and packs that phase A's full-size
# frames do not take, at sizes where the plain version runs in seconds
# (phase A and tests/test_torch_cuda_mesh.py): 240,000 and 100,000
# spheres walk trees 16 and 15 levels deep, the scene file's spheres one
# of three leaves over the floor's.
FUSED_CASES = (
    FusedCase("odd", "97x41, 3 spp: neither side a multiple of a block",
              2240, "colors", {"width": 97, "height": 41,
                               "rays_per_pixel": 3}, {}),
    FusedCase("one_sample", "rows 7-29 of 61x37, sample 4 of 10, summed",
              2240, "colors", {"width": 61, "height": 37},
              {"row_offset": 7.0, "n_rows": 23, "sample_offset": 4.0,
               "n_samples": 1, "reduce": "sum"}),
    FusedCase("three_samples", "samples 2-4 of 10", 2240, "colors",
              {"width": 61, "height": 37},
              {"sample_offset": 2.0, "n_samples": 3}),
    FusedCase("specular", "10 spp, specular", 2240, "colors",
              {"width": 61, "height": 37, "specular": True}, {}),
    FusedCase("subtract", "10 spp, energy model subtract", 2240, "colors",
              {"width": 61, "height": 37, "energy_model": "subtract"}, {}),
    FusedCase("image_sky", "milky_way bilinear, samples 5-9 summed", 2240,
              "milky_way", {"width": 61, "height": 37,
                            "skybox_bilinear": True},
              {"sample_offset": 5.0, "n_samples": 5, "reduce": "sum"}),
    FusedCase("rounds", "33 spp: rounds of 17 and 16 sample threads", 2240,
              "colors", {"width": 29, "height": 13, "rays_per_pixel": 33},
              {}, rounds=True),
    FusedCase("in_place", "240000 spheres: a tree 16 levels deep",
              240_000, "colors", {"width": 32, "height": 16,
                                  "rays_per_pixel": 2, "bounce_limit": 4},
              {}),
    FusedCase("in_place_rounds", "240000 spheres at 33 spp: a tree 16 "
              "levels deep, rounds of sample threads", 240_000, "colors",
              {"width": 8, "height": 4, "rays_per_pixel": 33,
               "bounce_limit": 4}, {}, rounds=True),
    FusedCase("rows_100k", "rows 131-133 of the 480x280x10 frame at 100000 "
              "spheres, 10 bounces", 100_000, "colors", {},
              {"row_offset": 131.0, "n_rows": 3}),
    FusedCase("scene_file", "SCENE_FILE's 9 spheres over the floor, "
              "uv_checker, 10 spp", 16, "uv_checker",
              {"width": 61, "height": 37}, {}, scene_file=True),
)

class RenderCase(NamedTuple):
    """A band of the demo scene (t = 1.5, the 'colors' sky) for the render
    kernel against its plain version: ``config`` the RenderConfig's
    fields, ``band`` render_band's row and sample arguments, ``spheres``
    the spheres of a crowded scene (``crowd``, one light of each kind; 0
    keeps the demo's six), ``pixel_rate`` the pixel-rate frame (16|16
    counts), ``staged`` whether the kernel stages the scene in shared
    memory, ``rounds`` whether a pixel's samples take more than one round
    of its sample threads: with the full frames of phases 2 and S6, the
    eight instantiations of render_kernel."""

    key: str
    label: str
    spheres: int
    config: dict
    band: dict
    pixel_rate: bool = False
    staged: bool = True
    rounds: bool = False


# The render kernel's launch shapes that the full frames of phases 2, M1
# and S6 do not take, at reduced sizes (phase M0 and
# tests/test_torch_cuda_render.py). 1400 spheres make a 50,772-byte scene,
# past the 48 KB the kernel stages in shared memory.
RENDER_CASES = (
    RenderCase("odd", "97x41, 3 spp: neither side a multiple of a block", 0,
               {"width": 97, "height": 41, "rays_per_pixel": 3}, {}),
    RenderCase("band", "rows 7-29 of 61x37, samples 3-7 of 10, summed", 0,
               {"width": 61, "height": 37},
               {"row_offset": 7, "n_rows": 23, "sample_offset": 3,
                "n_samples": 5, "reduce": "sum"}),
    RenderCase("rounds", "33 spp, specular: rounds of 17 and 16 sample "
               "threads", 0, {"width": 29, "height": 13,
                              "rays_per_pixel": 33, "specular": True}, {},
               rounds=True),
    RenderCase("in_place", "1400 spheres: the scene read in place", 1400,
               {"width": 64, "height": 32, "rays_per_pixel": 2,
                "bounce_limit": 3}, {}, staged=False),
    RenderCase("in_place_rounds", "1400 spheres at 33 spp, subtract", 1400,
               {"width": 16, "height": 8, "rays_per_pixel": 33,
                "bounce_limit": 3, "energy_model": "subtract"}, {},
               staged=False, rounds=True),
    RenderCase("rate_rounds", "pixel rate, 33 spp", 0,
               {"width": 29, "height": 13, "rays_per_pixel": 33}, {},
               pixel_rate=True, rounds=True),
    RenderCase("rate_in_place", "pixel rate, 1400 spheres", 1400,
               {"width": 64, "height": 32, "rays_per_pixel": 2,
                "bounce_limit": 3}, {}, pixel_rate=True, staged=False),
    RenderCase("rate_in_place_rounds", "pixel rate, 1400 spheres at 33 spp",
               1400, {"width": 16, "height": 8, "rays_per_pixel": 33,
                      "bounce_limit": 3}, {}, pixel_rate=True,
               staged=False, rounds=True),
)


class PathtraceCase(NamedTuple):
    """A frame of the demo scene (t = 1.5, the 'colors' sky, the demo's
    area light, frame_seed(0, 1.5)) for the path-tracing kernel against
    its plain version in both reduce modes: ``config`` the RenderConfig's
    fields, ``spheres`` the spheres of a crowded scene (``crowd``; 0
    keeps the demo's six), ``staged`` whether the kernel stages the scene
    in shared memory, ``rounds`` whether a pixel's samples take more than
    one round of its sample threads: with the full frames of phases P1
    and M2, the eight instantiations of pathtrace_kernel."""

    key: str
    label: str
    spheres: int
    config: dict
    staged: bool = True
    rounds: bool = False


# The path-tracing kernel's launch shapes that the full frames of phases
# P1 and M2 do not take, at reduced sizes (phase P1 and
# tests/test_torch_cuda_pathtrace.py). 1400 spheres and one area light
# make a 50,564-byte scene, past the 48 KB the kernel stages.
PATHTRACE_CASES = (
    PathtraceCase("odd", "97x41, 3 spp: neither side a multiple of a block",
                  0, {"width": 97, "height": 41, "rays_per_pixel": 3}),
    PathtraceCase("rounds", "33 spp: rounds of 17 and 16 sample threads", 0,
                  {"width": 29, "height": 13, "rays_per_pixel": 33},
                  rounds=True),
    PathtraceCase("in_place", "1400 spheres: the scene read in place", 1400,
                  {"width": 64, "height": 32, "rays_per_pixel": 2,
                   "bounce_limit": 3}, staged=False),
    PathtraceCase("in_place_rounds", "1400 spheres at 33 spp", 1400,
                  {"width": 16, "height": 8, "rays_per_pixel": 33,
                   "bounce_limit": 3}, staged=False, rounds=True),
)

# The many-object path tracer's launch shapes that phase PM1's full frame
# does not take, at reduced sizes (phase PM1 and
# tests/test_torch_cuda_pathtrace.py); ``spheres`` is the MeshScene's
# count. 240,000 spheres make a box table past a block's shared memory,
# as in FUSED_CASES: the boxes are read in place.
PATHTRACE_MESH_CASES = (
    PathtraceCase("mesh_odd", "97x41, 3 spp: neither side a multiple of a "
                  "block", N_SPHERES,
                  {"width": 97, "height": 41, "rays_per_pixel": 3,
                   "bounce_limit": 4}),
    PathtraceCase("mesh_rounds", "33 spp: rounds of 17 and 16 sample "
                  "threads", N_SPHERES,
                  {"width": 29, "height": 13, "rays_per_pixel": 33,
                   "bounce_limit": 4}, rounds=True),
    PathtraceCase("mesh_in_place", "240,000 spheres: the boxes read in "
                  "place", 240_000,
                  {"width": 24, "height": 12, "rays_per_pixel": 2,
                   "bounce_limit": 3}, staged=False),
    PathtraceCase("mesh_in_place_rounds", "240,000 spheres at 33 spp",
                  240_000, {"width": 8, "height": 4, "rays_per_pixel": 33,
                            "bounce_limit": 3}, staged=False, rounds=True),
)

# The sky-weight kernel's launch shapes that phase S5's full frame does
# not take: a ray count no multiple of a block, and the scene read in
# place (``PathtraceCase``'s fields; no rounds: one thread a ray).
SKY_CASES = (
    PathtraceCase("odd", "97x41, 3 spp: the rays no multiple of a block", 0,
                  {"width": 97, "height": 41, "rays_per_pixel": 3}),
    PathtraceCase("in_place", "1400 spheres: the scene read in place", 1400,
                  {"width": 64, "height": 32, "rays_per_pixel": 2,
                   "bounce_limit": 3}, staged=False),
)

# Phase SF's JSON scene file: 9 spheres on a 3x3 grid (some fields left to
# their defaults), two directional lights, no point light (the file format's
# black stand-in) and the ground at y = -1.
SCENE_FILE = {
    "spheres": [
        {"center": [-0.9, 0.0, -0.9], "radius": 0.4, "color": [1, 0, 0],
         "reflectivity": 1.0},
        {"center": [0.0, 0.2, -0.9], "radius": 0.3},
        {"center": [0.9, 0.0, -0.9], "color": [0, 0, 1],
         "reflectivity": 0.3},
        {"center": [-0.9, -0.3, 0.0], "radius": 0.35, "color": [0, 1, 1]},
        {"center": [0.0, 0.0, 0.0], "radius": 0.25, "color": [1, 1, 1],
         "reflectivity": 0.9, "specularity": 20},
        {"center": [0.9, 0.3, 0.0], "radius": 0.4, "color": [1, 0, 1],
         "reflectivity": 0.5},
        {"center": [-0.9, 0.0, 0.9], "radius": 0.3, "color": [1, 1, 0]},
        {"center": [0.0, -0.4, 0.9], "radius": 0.45,
         "color": [0.5, 0.8, 0.2], "reflectivity": 0.6},
        {"center": [0.9, 0.0, 0.9], "radius": 0.2, "color": [0.9, 0.5, 0.1],
         "reflectivity": 0.1},
    ],
    "ground": {"y": -1},
    "directional_lights": [
        {"direction": [-1, -1, -1], "color": [1, 1, 1]},
        {"direction": [1, -0.5, 0.3], "color": [0.4, 0.3, 0.2]},
    ],
    "point_lights": [],
}

# The card's peaks for the bounds (NVIDIA H100 SXM data sheet, at 700 W):
# FP32 outside the tensor cores, and device memory.
PEAK_FP32 = 67e12  # operations/s
PEAK_BYTES = 3.35e12  # bytes/s
# Floating-point operations (add, sub, mul, div, sqrt, min, max; an fma
# counts 2) of the kernels' inner tests, counted from the CUDA sources:
DEMO_SHADOW_SPHERE_OPS = 19  # render.cu blocked(), one sphere
DEMO_SHADOW_PLANE_OPS = 14  # render.cu blocked(), the ground plane
SLAB_OPS = 25  # mesh.cu quarter(): 6 sub, 6 mul, 13 min/max
SPHERE_OPS = 18  # mesh.cu sphere_hit(), no root (a miss)
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


def fused_case(dev, case: FusedCase) -> dict:
    """Render ``case`` with the fused kernel and its plain version on
    ``dev``: bit for bit equal, equal trace counts, the kernel launched
    once, its boxes staged and its samples in rounds as ``case`` says.
    Returns the exact_bar stats with the launch shape (``fused_layout``)
    and both sides' host-clock seconds."""
    import torch

    from ttrt_torch import assets
    from ttrt_torch.config import RenderConfig
    from ttrt_torch.frames import orbit_camera_frame
    from ttrt_torch.kernels import mesh_fused
    from ttrt_torch.mesh import bvh
    from ttrt_torch.mesh.scene import many_sphere_scene
    from ttrt_torch.scenefile import scene_from_dict

    cfg = RenderConfig(**case.config)
    scene = many_sphere_scene(assets.load_skybox(case.sky, device=dev),
                              case.spheres, cfg.width, cfg.height,
                              dtype=torch.float32, device=dev)
    if case.scene_file:
        scene = scene.with_spheres(scene_from_dict(
            SCENE_FILE, cfg.width, cfg.height, device=dev).spheres)
    scene = scene.with_camera_frame(
        orbit_camera_frame(3.3, dtype=torch.float32, device=dev))
    band = dict(case.band)
    rows = (band.pop("row_offset", 0.0), band.pop("n_rows", None))
    cuda = mesh_fused.render_band_mesh_fused_cuda
    before = cuda.launches
    t0 = time.perf_counter()
    fb_k, rays_k = cuda(scene, cfg, *rows, **band)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    fb_p, rays_p = mesh_fused.render_band_mesh_fused_plain(scene, cfg, *rows,
                                                           **band)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    assert cuda.launches == before + 1, (case.key, cuda.launches)
    n_rows = cfg.height if rows[1] is None else rows[1]
    out = fb_k.to_array().cpu().numpy()
    assert out.shape == (n_rows, cfg.width, 3) and np.isfinite(out).all()
    stats = exact_bar(fb_p.to_array().cpu().numpy(), out, rays_p, rays_k)
    assert stats["max_abs"] == 0.0 and stats["diff_px"] == 0, (case.key,
                                                               stats)
    n_samples = band.get("n_samples", cfg.rays_per_pixel)
    shape = mesh_fused.fused_layout(scene, cfg, n_rows, n_samples)
    assert (shape["sample_threads"] < n_samples) == case.rounds, (case.key,
                                                                  shape)
    stats["layout"] = {k: shape[k] for k in (
        "sample_threads", "threads_per_block", "blocks", "smem_bytes")}
    stats["tree_depth"] = bvh.depth(scene.clusters.tables.nodes.shape[0])
    stats["kernel_s"], stats["plain_s"] = t1 - t0, t2 - t1
    return stats


def render_case(dev, case: RenderCase) -> dict:
    """Render ``case`` with the render kernel and its plain version on
    ``dev``: bit for bit equal, equal trace counts, the kernel launched
    once, its scene staged and its samples in rounds as ``case`` says.
    Returns the exact_bar stats with the launch shape (``render_layout``)."""
    import torch

    from ttrt_torch import assets
    from ttrt_torch.config import RenderConfig
    from ttrt_torch.frames import orbit_camera_frame
    from ttrt_torch.kernels import render
    from ttrt_torch.scene import demo_scene

    cfg = RenderConfig(**case.config)
    scene = demo_scene(assets.load_skybox("colors", device=dev), cfg.width,
                       cfg.height, dtype=torch.float32, device=dev)
    scene = scene.with_camera_frame(
        orbit_camera_frame(1.5, dtype=torch.float32, device=dev))
    if case.spheres:
        scene = crowd(scene, case.spheres, 1, 1, seed=4)
    band = dict(case.band)
    rows = (band.pop("row_offset", 0), band.pop("n_rows", None))
    if case.pixel_rate:
        cuda = render.render_frame_pixel_rate_cuda
        kernel = lambda: cuda(scene, cfg)  # noqa: E731
        plain = lambda: render.render_frame_pixel_rate_plain(  # noqa: E731
            scene, cfg)
    else:
        cuda = render.render_band_cuda
        kernel = lambda: cuda(scene, cfg, *rows, **band)  # noqa: E731
        plain = lambda: render.render_band_plain(  # noqa: E731
            scene, cfg, *rows, **band)
    before = cuda.launches
    fb_k, rays_k = kernel()
    fb_p, rays_p = plain()
    torch.cuda.synchronize()
    assert cuda.launches == before + 1, (case.key, cuda.launches)
    n_rows = cfg.height if rows[1] is None else rows[1]
    out = fb_k.to_array().cpu().numpy()
    assert out.shape == (n_rows, cfg.width, 3) and np.isfinite(out).all()
    stats = exact_bar(fb_p.to_array().cpu().numpy(), out, rays_p, rays_k)
    assert stats["max_abs"] == 0.0 and stats["diff_px"] == 0, (case.key,
                                                               stats)
    n_samples = band.get("n_samples", cfg.rays_per_pixel)
    shape = render.render_layout(scene, cfg, n_rows, n_samples,
                                 case.pixel_rate)
    assert shape["scene_staged"] == int(case.staged), (case.key, shape)
    assert (shape["sample_threads"] < n_samples) == case.rounds, (case.key,
                                                                  shape)
    stats["layout"] = {k: shape[k] for k in (
        "sample_threads", "threads_per_block", "blocks", "smem_bytes",
        "scene_staged")}
    return stats


def _case_scene(dev, case: PathtraceCase):
    """``case``'s RenderConfig and its demo scene at t = 1.5."""
    import torch

    from ttrt_torch import assets
    from ttrt_torch.config import RenderConfig
    from ttrt_torch.frames import orbit_camera_frame
    from ttrt_torch.scene import demo_scene

    cfg = RenderConfig(**case.config)
    scene = demo_scene(assets.load_skybox("colors", device=dev), cfg.width,
                       cfg.height, dtype=torch.float32, device=dev)
    scene = scene.with_camera_frame(
        orbit_camera_frame(1.5, dtype=torch.float32, device=dev))
    if case.spheres:
        scene = crowd(scene, case.spheres, 1, 1, seed=4)
    return cfg, scene


def pathtrace_exact(scene, lights, cfg, seed: int, reduce: str = "mean",
                    label=None) -> dict:
    """pathtrace_frame_cuda against its plain version on the same card
    tensors: frames bit for bit equal, equal work, the kernel launched
    once. Returns the stats; ``label`` names the case in a failure."""
    import torch

    from ttrt_torch.kernels import pathtrace

    cuda = pathtrace.pathtrace_frame_cuda
    before = cuda.launches
    fb_k, work_k = cuda(scene, lights, cfg, seed, reduce=reduce)
    fb_p, work_p = pathtrace.pathtrace_frame_plain(scene, lights, cfg, seed,
                                                   reduce=reduce)
    torch.cuda.synchronize()
    assert cuda.launches == before + 1, (label, cuda.launches)
    k = fb_k.to_array().cpu().numpy()
    assert k.shape == (cfg.height, cfg.width, 3) and np.isfinite(k).all()
    d = np.abs(fb_p.to_array().cpu().numpy().astype(np.float64) - k)
    stats = {"max_abs": float(d.max()),
             "diff_px": int((d > 0).any(axis=-1).sum()),
             "work": [int(v) for v in work_k],
             "work_ref": [int(v) for v in work_p]}
    assert (stats["max_abs"] == 0.0 and stats["diff_px"] == 0
            and stats["work"] == stats["work_ref"]), (label, reduce, stats)
    return stats


def pathtrace_case(dev, case: PathtraceCase, mesh: bool = False) -> dict:
    """Path-trace ``case`` with the kernel and its plain version on
    ``dev``, the clipped mean and the sum (``pathtrace_exact`` each), its
    scene (with ``mesh``: its boxes) staged and its samples in rounds as
    ``case`` says; ``mesh`` takes the many-object scene of
    ``case.spheres`` spheres at t = 1.5. Returns each mode's stats and the
    launch shape (``pathtrace_layout``)."""
    from ttrt_torch.config import RenderConfig
    from ttrt_torch.kernels import pathtrace
    from ttrt_torch.render import pathtrace as estimator

    if mesh:
        cfg = RenderConfig(**case.config)
        scene = pathtrace_mesh_scene(dev, case.spheres, cfg, 1.5)
    else:
        cfg, scene = _case_scene(dev, case)
    lights = estimator.default_area_lights(cfg, dev)
    seed = pathtrace.frame_seed(0, 1.5)
    out = {}
    for reduce in pathtrace.REDUCE:
        out[reduce] = pathtrace_exact(scene, lights, cfg, seed, reduce,
                                      case.key)
        shape = pathtrace.pathtrace_layout(scene, lights, cfg, reduce)
        assert shape["scene_staged"] == int(case.staged), (case.key, shape)
        assert (shape["sample_threads"] < cfg.rays_per_pixel) == case.rounds
    out["layout"] = {k: shape[k] for k in (
        "sample_threads", "threads_per_block", "blocks", "smem_bytes",
        "scene_staged", "registers", "local_bytes")}
    return out


def pathtrace_mesh_scene(dev, n_spheres: int, cfg, t: float):
    """The many-object scene of ``n_spheres`` spheres (seed 0) under
    'colors', its camera on the orbit at ``t``."""
    import torch

    from ttrt_torch import assets
    from ttrt_torch.frames import orbit_camera_frame
    from ttrt_torch.mesh.scene import many_sphere_scene

    scene = many_sphere_scene(assets.load_skybox("colors", device=dev),
                              n_spheres, cfg.width, cfg.height,
                              dtype=torch.float32, device=dev)
    return scene.with_camera_frame(
        orbit_camera_frame(t, dtype=torch.float32, device=dev))


def pathtrace_mesh_rows(scene, lights, cfg, seed: int, n_rows: int,
                        draw: int = 0) -> dict:
    """The many-object path tracer's whole frame against its plain
    version's ``n_rows`` rows drawn by ``default_rng(draw)``, on the same
    card tensors: those rows bit for bit equal. Returns the stats."""
    import torch

    from ttrt_torch.kernels import pathtrace

    rows = sorted(np.random.default_rng(draw).choice(
        cfg.height, n_rows, replace=False).tolist())
    fb_k, work_k = pathtrace.pathtrace_frame_cuda(scene, lights, cfg, seed)
    fb_p, work_p = pathtrace.pathtrace_frame_plain(scene, lights, cfg, seed,
                                                   rows=rows)
    torch.cuda.synchronize()
    k = fb_k.to_array().cpu().numpy()
    assert k.shape == (cfg.height, cfg.width, 3) and np.isfinite(k).all()
    d = np.abs(fb_p.to_array().cpu().numpy().astype(np.float64) - k[rows])
    stats = {"rows": rows, "max_abs": float(d.max()),
             "diff_px": int((d > 0).any(axis=-1).sum()),
             "work": [int(v) for v in work_k],
             "rows_work_ref": [int(v) for v in work_p]}
    assert stats["max_abs"] == 0.0 and stats["diff_px"] == 0, stats
    return stats


def sky_case(dev, case: PathtraceCase) -> dict:
    """The sky weights of ``case`` with the kernel and its plain version on
    ``dev``: bit for bit equal, the kernel launched once, its scene staged
    as ``case`` says. Returns the stats and the launch shape
    (``sky_weights_layout``)."""
    import torch

    from ttrt_torch.kernels import render

    cfg, scene = _case_scene(dev, case)
    cuda = render.sky_weights_cuda
    before = cuda.launches
    w_k = cuda(scene, cfg)
    w_p = render.sky_weights_plain(scene, cfg)
    torch.cuda.synchronize()
    assert cuda.launches == before + 1, (case.key, cuda.launches)
    assert w_k.shape == (cfg.rays_per_pixel, cfg.height, cfg.width)
    assert bool(torch.isfinite(w_k).all())
    stats = {"max_abs": float((w_k - w_p).abs().max()),
             "diff": int((w_k != w_p).sum()), "rays": w_k.numel()}
    assert stats["diff"] == 0, (case.key, stats)
    shape = render.sky_weights_layout(scene, cfg)
    assert shape["scene_staged"] == int(case.staged), (case.key, shape)
    stats["layout"] = {k: shape[k] for k in (
        "threads_per_block", "blocks", "smem_bytes", "scene_staged")}
    return stats


def nearest_case(dev, n_spheres: int) -> dict:
    """cluster_nearest_cuda on the primary rays of a 64x32x2 frame of an
    ``n_spheres`` scene (t = 3.3) against the dense tester (nearest_bar);
    the stats with the launch shape (``nearest_layout``)."""
    import torch

    from ttrt_torch import assets
    from ttrt_torch.config import RenderConfig
    from ttrt_torch.frames import orbit_camera_frame
    from ttrt_torch.kernels import mesh
    from ttrt_torch.mesh.dense import dense_nearest
    from ttrt_torch.mesh.scene import many_sphere_scene
    from ttrt_torch.render.integrator import generate_rays
    from ttrt_torch.vec import Vec3

    cfg = RenderConfig(width=64, height=32, rays_per_pixel=2)
    scene = many_sphere_scene(assets.load_skybox("colors", device=dev),
                              n_spheres, cfg.width, cfg.height,
                              dtype=torch.float32, device=dev)
    scene = scene.with_camera_frame(
        orbit_camera_frame(3.3, dtype=torch.float32, device=dev))
    o, d = generate_rays(scene, cfg)
    o = Vec3(*(c.contiguous() for c in o))
    stats = nearest_bar(dense_nearest(scene.spheres, scene.triangles, o, d),
                        mesh.cluster_nearest_cuda(scene.clusters, o, d))
    stats["subclusters"] = scene.clusters.kb_sph + scene.clusters.kb_tri
    stats["layout"] = mesh.nearest_layout(o.x.numel())
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


def _issued(warp, idx, per_lane, n_warps: int) -> int:
    """Work that warps issue for their lanes ``idx`` doing ``per_lane``
    each (one branch, lockstep): the sum over warps of their busiest
    lane's."""
    import torch

    if idx.numel() == 0:
        return 0
    top = torch.zeros(n_warps, dtype=per_lane.dtype, device=per_lane.device)
    top.scatter_reduce_(0, warp[idx], per_lane, "amax")
    return int(top.sum())


def _narrow(tab, is_tri: bool, pos, rays, tmax, shadow: bool):
    """The kernels' narrow test of each ray (1-D components ``rays``)
    against the object at its table position ``pos``: (t, hit), or with
    ``shadow`` (None, blocked before ``tmax`` when it is not None) along
    unit directions. The arithmetic of ``mesh.dense``, elementwise."""
    from ttrt_torch.mesh.dense import _sphere_t, _tri_t, sphere_blocks
    from ttrt_torch.vec import scalar_like

    ox, oy, oz, dx, dy, dz = rays
    if is_tri:
        t, hit = _tri_t(*tab.tri[pos, :9].unbind(1), ox, oy, oz, dx, dy, dz)
        if shadow:
            return None, hit if tmax is None else hit & (t < tmax)
        return t, hit
    c = tab.sph[pos].unbind(1)
    if shadow:
        soo = ox * ox + oy * oy + oz * oz
        od = ox * dx + oy * dy + oz * dz
        return None, sphere_blocks(*c, ox, oy, oz, dx, dy, dz, soo, od, tmax)
    a = dx * dx + dy * dy + dz * dz
    inv2a = scalar_like(0.5, a) / a
    od = ox * dx + oy * dy + oz * dz
    oo = ox * ox + oy * oy + oz * oz
    return _sphere_t(*c, ox, oy, oz, dx, dy, dz, od, oo, 4.0 * a, inv2a)


def _slab(lo, hi, rays, inv):
    """(entry, pass) of the kernels' slab test (mesh.cu quarter()) of each
    ray against its box (lo, hi), (R, 3) rows."""
    import torch

    tn = tf = None
    for i in range(3):
        t1 = (lo[:, i] - rays[i]) * inv[i]
        t2 = (hi[:, i] - rays[i]) * inv[i]
        near, far = torch.minimum(t1, t2), torch.maximum(t1, t2)
        tn = near if tn is None else torch.maximum(tn, near)
        tf = far if tf is None else torch.minimum(tf, far)
    return tn, tf >= torch.clamp_min(tn, 0.0)


def walk_work(pack, o, d, *, tree: bool = False, order=None,
              shadow: bool = False, tmax=None, warp=None) -> dict:
    """Replay a many-object walk of csrc/mesh.cu in torch on the rays
    (o, d), vectorized over the rays, with the kernels' slab test (on the
    kernel tables' widened boxes, the clamped 1/d) and their narrow tests
    (``mesh.dense``'s arithmetic). The walk: the flat sweep of the quarter
    boxes (``tree`` False), subcluster by subcluster in index order
    (cluster_nearest_kernel) or in the visit ``order`` ((K,) subclusters;
    the fused kernel's before its tree), skipping a quarter entered after
    the ray's limit; or the fused kernel's walk of the pack's tree
    (``tree``, BvhTracer): from the root, both children slab-tested, the
    nearer that the ray enters before its limit taken, the other pushed,
    a popped node entered after the limit skipped. The limit is the
    running best t of a nearest-hit trace, which folds the hits with the
    lowest id winning a tie; with ``shadow``, the any-hit shadow test
    along unit directions, ``tmax`` (blockers before it only) or none,
    which stops at the first blocker.

    Returns ``hit`` (a NearestHit, which must equal the kernel's and the
    plain versions' bit for bit) or with ``shadow`` ``blocked``; each
    ray's narrow tests (``tests``) and slab tests (``slabs``); for the
    flat walk ``first``, the box-table row of the first quarter a ray
    narrow-tests (-1 for none); and for the warps (``warp``, each ray's
    warp id; 32 consecutive rays by default) the lane tests, the tests
    the warps issue and their ratio ``simt``, lane tests over 32 times
    the issued ones, for the narrow tests and (``*_slabs``) the slab
    tests. A warp issues, for each step of the walk, its busiest lane's
    work: in the flat walk a quarter any lane takes costs its warp the
    tests its lanes make there; in the tree walk a step of a lane at an
    internal node costs the warp its busiest lane's slab tests (two, less
    an empty child's), and one at a leaf its busiest lane's narrow
    tests."""
    import torch

    from ttrt_torch.kernels.mesh import _float32_rays, _tables

    tab = _tables(pack)
    rays = _float32_rays(o, d)
    R, dev = rays[0].numel(), rays[0].device
    if warp is None:
        warp = torch.arange(R, device=dev) // 32
    n_warps = int(warp.max()) + 1 if R else 0
    inv = []
    for dc in rays[3:]:
        m = torch.clamp_min(dc.abs(), 1e-12)
        inv.append(1.0 / torch.where(dc >= 0.0, m, -m))
    if shadow:
        blocked = torch.zeros(R, dtype=torch.bool, device=dev)
        limit_all = (torch.full((R,), float("inf"), device=dev)
                     if tmax is None else tmax.to(torch.float32))
    best_t = torch.full((R,), float("inf"), dtype=torch.float32, device=dev)
    best_id = torch.full((R,), -1, dtype=torch.int32, device=dev)
    tests = torch.zeros(R, dtype=torch.int64, device=dev)
    slabs = torch.zeros(R, dtype=torch.int64, device=dev)
    count = {"warp_tests": 0, "warp_slabs": 0}

    def limit(idx):
        return limit_all[idx] if shadow else best_t[idx]

    def at(idx):
        return [r[idx] for r in rays]

    def narrow(idx, is_tri, pos, sel):
        """Narrow-test rays idx at positions pos where sel, folding the
        hits into their results; returns the hit mask."""
        t, hit = _narrow(tab, is_tri, pos, at(idx), None if tmax is None
                         else tmax[idx], shadow)
        hit = hit & sel
        if shadow:
            blocked[idx] |= hit
            return hit
        ids = (tab.tri_id if is_tri else tab.sph_id)[pos]
        bt, bi = best_t[idx], best_id[idx]
        win = hit & ~(t > bt) & ((t < bt) | (ids < bi))
        best_t[idx] = torch.where(win, t, bt)
        best_id[idx] = torch.where(win, ids, bi)
        return hit

    def lanes(idx, n):
        """Count n tests (a tensor) of rays idx; returns the warps'."""
        tests[idx] += n
        count["warp_tests"] += _issued(warp, idx, n, n_warps)

    if tree:
        first = None
        _walk_tree(tab, rays, inv, limit, narrow, lanes, slabs, count,
                   warp, n_warps, blocked if shadow else None)
    else:
        first = _walk_flat(tab, rays, inv, order, limit, narrow, lanes,
                           slabs, count, warp, n_warps,
                           blocked if shadow else None)
    lane_tests, lane_slabs = int(tests.sum()), int(slabs.sum())
    out = {"tests": tests, "slabs": slabs, "first": first,
           "lane_tests": lane_tests, "lane_slabs": lane_slabs, **count}
    for kind in ("tests", "slabs"):
        issued = count["warp_" + kind]
        out["simt" if kind == "tests" else "slab_simt"] = (
            out["lane_" + kind] / (32 * issued) if issued else 1.0)
    if shadow:
        out["blocked"] = blocked
    else:
        from ttrt_torch.mesh.dense import NearestHit

        out["hit"] = NearestHit(best_t, best_id)
    return out


def _walk_flat(tab, rays, inv, order, limit, narrow, lanes, slabs, count,
               warp, n_warps, blocked):
    """walk_work's flat sweep; returns ``first``."""
    import torch

    R, dev = rays[0].numel(), rays[0].device
    first = torch.full((R,), -1, dtype=torch.int64, device=dev)
    counts = tab.qbox[:, 6].to(torch.int64).tolist()
    K = tab.kb_sph + tab.kb_tri
    subs = range(K) if order is None else [int(s) for s in order]
    every = torch.arange(R, device=dev)
    for sub in subs:
        is_tri = sub >= tab.kb_sph
        for q in range(4):
            row, n = 4 * sub + q, counts[4 * sub + q]
            if n == 0:
                continue
            live = every if blocked is None else every[~blocked]
            if live.numel() == 0:
                return first
            slabs[live] += 1
            count["warp_slabs"] += _issued(
                warp, live, torch.ones_like(live), n_warps)
            box = tab.qbox[row].expand(live.numel(), 8)
            tn, ok = _slab(box[:, :3], box[:, 3:6], [r[live] for r in rays],
                           [v[live] for v in inv])
            idx = live[ok & ~(tn > limit(live))]
            if idx.numel() == 0:
                continue
            first[idx] = torch.where(first[idx] < 0, row, first[idx])
            base = (sub - tab.kb_sph if is_tri else sub) * 128 + q * 32
            done = torch.zeros(idx.numel(), dtype=torch.int64, device=dev)
            stop = torch.zeros(idx.numel(), dtype=torch.bool, device=dev)
            for j in range(n):
                pos = torch.full_like(idx, base + j)
                done += (~stop).to(torch.int64)
                hit = narrow(idx, is_tri, pos, ~stop)
                if blocked is not None:
                    stop |= hit
            lanes(idx, done)
    return first


def _walk_tree(tab, rays, inv, limit, narrow, lanes, slabs, count, warp,
               n_warps, blocked):
    """walk_work's tree walk."""
    import torch

    from ttrt_torch.mesh import bvh

    nodes = tab.nodes
    P = nodes.shape[0] // 2
    R, dev = rays[0].numel(), rays[0].device
    tri0 = tab.kb_sph * 128
    n_obj = nodes[:, 6].to(torch.int64)
    first = nodes[:, 7].to(torch.int64)
    depth = bvh.depth(nodes.shape[0])
    stack = torch.zeros((R, depth + 1), dtype=torch.int64, device=dev)
    stack_t = torch.zeros((R, depth + 1), dtype=torch.float32, device=dev)
    sp = torch.zeros(R, dtype=torch.int64, device=dev)
    node = torch.ones(R, dtype=torch.int64, device=dev)

    def enter(idx, rows):
        """(entry, goes) of rays idx into nodes rows: a real box entered
        before the ray's limit."""
        box = nodes[rows]
        tn, ok = _slab(box[:, :3], box[:, 3:6], [r[idx] for r in rays],
                       [v[idx] for v in inv])
        return tn, ok & (n_obj[rows] > 0) & ~(tn > limit(idx))

    every = torch.arange(R, device=dev)
    if n_obj[1] > 0:
        slabs += 1
        count["warp_slabs"] += _issued(warp, every, torch.ones_like(every),
                                       n_warps)
    _, go = enter(every, node)
    active = every[go]
    while active.numel():
        leaf = node[active] >= P
        inner = active[~leaf]
        c = 2 * node[inner]
        t0, go0 = enter(inner, c)
        t1, go1 = enter(inner, c + 1)
        real = (n_obj[c] > 0).to(torch.int64) + (n_obj[c + 1] > 0).to(
            torch.int64)  # quarter() skips an empty node's slab test
        slabs[inner] += real
        count["warp_slabs"] += _issued(warp, inner, real, n_warps)
        both = go0 & go1
        right = t1 < t0
        push = inner[both]
        stack[push, sp[push]] = torch.where(right, c, c + 1)[both]
        stack_t[push, sp[push]] = torch.where(right, t0, t1)[both]
        sp[push] += 1
        node[inner] = torch.where(both, torch.where(right, c + 1, c),
                                  torch.where(go0, c, c + 1))
        pop = [inner[~(go0 | go1)]]

        ll = active[leaf]
        rows = node[ll]
        f, n = first[rows], n_obj[rows]
        done = torch.zeros_like(ll)
        stop = torch.zeros(ll.numel(), dtype=torch.bool, device=dev)
        for j in range(int(n.max()) if ll.numel() else 0):
            sel = (j < n) & ~stop
            done += sel.to(torch.int64)
            for is_tri in (False, True):
                kind = (f >= tri0) == is_tri
                pos = (f - (tri0 if is_tri else 0) + j)[kind]
                hit = narrow(ll[kind], is_tri, pos, sel[kind])
                if blocked is not None:
                    stop[kind] |= hit
        lanes(ll, done)
        pop.append(ll[~stop])
        active = inner[go0 | go1]
        pending = torch.cat(pop)
        while pending.numel():
            empty = sp[pending] == 0
            pending = pending[~empty]
            sp[pending] -= 1
            top = sp[pending]
            skip = stack_t[pending, top] > limit(pending)
            took = pending[~skip]
            node[took] = stack[took, sp[took]]
            active = torch.cat([active, took])
            pending = pending[skip]


def fused_batches(scene, cfg, bounce: int, pixels_per_block: int) -> dict:
    """The rays the fused kernel traces in one frame, taken from a run of
    its plain version (which makes the kernel's traces, bounce by
    bounce): ``primary`` and ``bounce`` (at bounce ``bounce``, the live
    rays), each (o, d, warp); and the shadow rays of the primary hits,
    ``shadow_dl`` / ``shadow_pl`` for the first light of each kind, each
    (p, l, tmax or None, warp). ``warp`` is the id of the kernel's warp
    that traces each ray, for one round of sample threads (N <= 32): a
    pixel's N samples on neighbouring threads, ``pixels_per_block``
    pixels a block (``fused_layout``)."""
    import torch

    from ttrt_torch.config import constants
    from ttrt_torch.kernels import mesh_fused
    from ttrt_torch.vec import Vec3

    n_px, N = cfg.width * cfg.height, cfg.rays_per_pixel
    real_trace = mesh_fused.mesh_trace
    real_shadow = mesh_fused._shadow_blocked
    state = {"bounce": -1}
    out = {}

    def warp_of(i):
        pix, k = i % n_px, i // n_px
        per_block = (pixels_per_block * N + 31) // 32
        return ((pix // pixels_per_block) * per_block
                + ((pix % pixels_per_block) * N + k) // 32)

    def trace(sph, tri, ox, oy, oz, dx, dy, dz):
        hit = real_trace(sph, tri, ox, oy, oz, dx, dy, dz)
        if state["bounce"] < 0:
            state["contrib"] = torch.ones(n_px * N, device=ox.device)
        state["bounce"] += 1
        contrib = state["contrib"]
        live = torch.nonzero(contrib > constants.CONTRIBUTION_EPS)[:, 0]
        assert live.numel() == ox.numel(), (live.numel(), ox.numel())
        contrib[live] = torch.where(hit.is_hit, contrib[live] * hit.refl,
                                    0.0)
        state["live"], state["hit"] = live, hit.is_hit
        kind = {0: "primary", bounce: "bounce"}.get(state["bounce"])
        if kind:
            out[kind] = (Vec3(ox, oy, oz), Vec3(dx, dy, dz), warp_of(live))
        return hit

    def shadow(sph, tri, px, py, pz, lx, ly, lz, tmax):
        kind = "shadow_dl" if tmax is None else "shadow_pl"
        if state["bounce"] == 0 and kind not in out:
            keep = torch.nonzero(state["hit"])[:, 0]
            out[kind] = (Vec3(px[keep], py[keep], pz[keep]),
                         Vec3(*(torch.broadcast_to(v, px.shape)[keep]
                                for v in (lx, ly, lz))),
                         None if tmax is None else tmax[keep],
                         warp_of(state["live"][keep]))
        return real_shadow(sph, tri, px, py, pz, lx, ly, lz, tmax)

    mesh_fused.mesh_trace = trace
    mesh_fused._shadow_blocked = shadow
    try:
        mesh_fused.render_band_mesh_fused_plain(scene, cfg)
    finally:
        mesh_fused.mesh_trace = real_trace
        mesh_fused._shadow_blocked = real_shadow
    return out


def eager_batches(scene, cfg) -> list:
    """The ray batches that one frame of the eager integrator
    (``render.integrator.render_frame``) hands ``cluster_nearest_cuda``,
    in call order, as flat (o, d) Vec3 pairs: for each bounce its
    nearest-hit batch, then one shadow batch a light (the directional
    lights first). Every batch has the frame's full length, dead rays
    included, in pixel-major order. They are copied where the integrator
    dispatches a trace (``render.dispatch``), whose ``MeshScene`` tracer
    hands its rays to the wrapper unchanged; the wrapper and its launch
    count are left alone."""
    from ttrt_torch.mesh.scene import MeshScene, trace_ray_mesh
    from ttrt_torch.render import dispatch
    from ttrt_torch.render.integrator import render_frame
    from ttrt_torch.vec import Vec3

    calls = []

    def record(scene, o, d, **kw):
        calls.append(tuple(Vec3(*(c.reshape(-1).clone() for c in v))
                           for v in (o, d)))
        return trace_ray_mesh(scene, o, d, **kw)

    dispatch.register_trace(MeshScene, record)
    try:
        render_frame(scene, cfg)
    finally:
        dispatch.register_trace(MeshScene, trace_ray_mesh)
    return calls


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


def _ptxas_lines(report: str, name: str = "mesh_fused_kernel") -> list:
    """The lines of an nvcc -Xptxas -v report that belong to the entry
    functions whose mangled name holds ``name``."""
    out, current = [], ""
    for line in report.splitlines():
        if "Compiling entry function" in line:
            current = line
        if name in current and any(
                k in line for k in ("entry function", "registers", "spill")):
            out.append(line.strip())
    return out


def ptxas_spills(report: str, name: str) -> dict:
    """{mangled entry name: spill store bytes} of the entry functions of
    an nvcc -Xptxas -v report whose name holds ``name``."""
    out, entry = {}, None
    for line in _ptxas_lines(report, name):
        m = re.search(r"entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and entry:
            out[entry] = int(m.group(1))
    return out


def parent_module(parent: str, module: str):
    """Module ``module`` (a dotted path, such as
    "ttrt_torch.kernels.build") of the checkout at ``parent``, loaded
    beside this checkout's package, which its imports name."""
    import importlib.util

    path = os.path.join(parent, *module.split(".")) + ".py"
    spec = importlib.util.spec_from_file_location(
        "parent_" + module.replace(".", "_"), path)
    out = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(out)
    return out


def parent_call(parent: str, module: str, name: str):
    """Function ``name`` of the parent checkout's ``module``
    (``parent_module``); each call runs with
    ``ttrt_torch.kernels.build.load`` swapped for the parent's, so that
    its wrappers launch the parent's kernels through the parent's C
    interface. The parent's library builds from its own sources into its
    own ``_build``. For timing a parent's kernel in this process."""
    from ttrt_torch.kernels import build

    parent_load = parent_module(parent, "ttrt_torch.kernels.build").load
    fn = getattr(parent_module(parent, module), name)

    def call(*args, **kw):
        saved, build.load = build.load, parent_load
        try:
            return fn(*args, **kw)
        finally:
            build.load = saved

    return call


def on_streams(streams, calls) -> list:
    """Run ``calls[i]()`` on ``streams[i]``, each after the current
    stream's work so far, and make the current stream wait for all of
    them. Returns the calls' results."""
    import torch

    here = torch.cuda.current_stream()
    out = []
    for s, call in zip(streams, calls):
        s.wait_stream(here)
        with torch.cuda.stream(s):
            out.append(call())
    for s in streams:
        here.wait_stream(s)
    return out


def demo_bound(rays: int, n_px: int, texel_bytes: int = 0,
               n_spheres: int = 6, n_dlights: int = 1, n_plights: int = 1):
    """The demo kernel's bound (``bound_ms``): every trace costs at least a
    shadow trace (the cheaper kind) against the spheres (6 in the demo)
    and the plane; it reads the packed scene and the sky's texels (an
    image sky's, once) and writes 16 bytes a pixel."""
    return bound_ms(
        rays * (n_spheres * DEMO_SHADOW_SPHERE_OPS + DEMO_SHADOW_PLANE_OPS),
        4 * (17 + 9 * n_spheres + 16 + 6 * n_dlights + 7 * n_plights)
        + texel_bytes + 16 * n_px)


def file_scene_case(scene, cfg) -> dict:
    """A JSON scene on the card through render_frame_cuda and
    render_frame_plain: phase 2's bar, bit for bit, equal traces."""
    import torch
    from ttrt_torch.kernels import render

    before = render.render_frame_cuda.launches
    fb_k, rays_k = render.render_frame_cuda(scene, cfg)
    assert render.render_frame_cuda.launches == before + 1
    fb_p, rays_p = render.render_frame_plain(scene, cfg)
    torch.cuda.synchronize()
    out = fb_k.to_array().cpu().numpy()
    assert out.shape == (cfg.height, cfg.width, 3) and np.isfinite(out).all()
    stats = exact_bar(fb_p.to_array().cpu().numpy(), out, rays_p, rays_k)
    assert stats["max_abs"] == 0.0, stats
    return stats


def file_pathtrace_case(scene, cfg, seed: int) -> dict:
    """A JSON scene on the card through pathtrace_frame_cuda and its plain
    version with the demo's area light: phase P1's bar, bit for bit,
    equal work."""
    import torch
    from ttrt_torch.kernels import pathtrace
    from ttrt_torch.render.pathtrace import default_area_lights

    lights = default_area_lights(cfg, scene.spheres.radius.device)
    before = pathtrace.pathtrace_frame_cuda.launches
    fb_k, work_k = pathtrace.pathtrace_frame_cuda(scene, lights, cfg, seed)
    assert pathtrace.pathtrace_frame_cuda.launches == before + 1
    fb_p, work_p = pathtrace.pathtrace_frame_plain(scene, lights, cfg, seed)
    torch.cuda.synchronize()
    out = fb_k.to_array().cpu().numpy()
    assert out.shape == (cfg.height, cfg.width, 3) and np.isfinite(out).all()
    stats = plain_bar(fb_p.to_array().cpu().numpy(), out,
                      pathtrace.total_traces(work_p, lights.count),
                      pathtrace.total_traces(work_k, lights.count))
    stats["work"] = [int(v) for v in work_k]
    stats["work_ref"] = [int(v) for v in work_p]
    assert stats["max_abs"] == 0.0 and stats["work"] == stats["work_ref"], (
        stats)
    return stats


# the two physics worlds of phase PH: the demo drop, frames of 4 substeps
# of 1/60 s; tests/test_physics.py's two spheres head-on (restitution 1,
# no gravity), steps of 0.01 s
PHYSICS_WORLDS = ("demo", "head-on")
# a physics run on the card against the same run on the CPU, float32: the
# same IEEE operations in the same order (no atomics, no fused multiply-add)
PHYSICS_TOL = 1e-6
CKPT_FRAMES = 3  # frames each --checkpoint process of phase PH steps
# frames of the drop the kernel is held to the benchmark's reference (about
# 130 s of sim time: what a 51-s window of physics.drop steps at 150 fps)
PHYSICS_REFERENCE_FRAMES = 8000


def physics_world(world: str, device):
    """(state, params, dt, substeps) of a ``PHYSICS_WORLDS`` world in
    float32 on ``device``."""
    import torch
    from ttrt_torch import assets
    from ttrt_torch.physics import demo, world as pworld
    from ttrt_torch.scene import demo_scene

    if world == "demo":
        scene = demo_scene(assets.load_skybox("colors", device=device), 8, 4,
                           dtype=torch.float32, device=device)
        state, params = demo.build_physics_demo(scene)
        return state, params, 1.0 / 60.0, demo.SUBSTEPS
    params = pworld.default_params([0.5, 0.5], device=device)._replace(
        gravity=torch.zeros(3, device=device),
        restitution=torch.tensor(1.0, device=device))
    state = demo.physics_state_from_numpy(
        [np.array([-1.0, 1.0]), np.zeros(2), np.zeros(2),
         np.array([2.0, -2.0]), np.zeros(2), np.zeros(2), np.zeros(())],
        dtype=torch.float32, device=device)
    return state, params, 0.01, 1


def physics_pile(n: int, device):
    """(state, params, dt, substeps) of ``n`` spheres in float32 on
    ``device``: radii drawn in [0.3, 0.6), stacked 1.1 apart in y over x,
    z drawn in [-0.05, 0.05), velocities drawn in [-0.05, 0.05), dropped
    under the demo's gravity onto its ground and walls with restitution
    0.2, so that the spheres land and rest on each other: a world whose
    pairs touch, of another size than the demo's six."""
    import torch
    from ttrt_torch.physics import demo, world as pworld

    rng = np.random.default_rng(n)
    x, z = rng.uniform(-0.05, 0.05, (2, n))
    y = -1.0 + 1.1 * np.arange(n)
    v = rng.uniform(-0.05, 0.05, (3, n))
    params = pworld.default_params(rng.uniform(0.3, 0.6, n), device=device,
                                   ground_y=-2.0, restitution=0.2,
                                   bounds=4.0)
    state = demo.physics_state_from_numpy([x, y, z, *v, np.zeros(())],
                                          dtype=torch.float32,
                                          device=device)
    return state, params, 1.0 / 60.0, demo.SUBSTEPS


def pair_touching(state, params, ii, jj):
    """Whether a pair (ii, jj) of the state's spheres touches (their gap
    under 1e-4): a 0-dim bool tensor on the state's device."""
    p = state.pos.to_array()
    gap = ((p[ii] - p[jj]).norm(dim=1)
           - params.radius[ii] - params.radius[jj])
    return (gap < 1e-4).any()


def physics_bits(state):
    """A state's 7 leaves as one int32 tensor of their float32 bits."""
    import torch

    leaves = [*state.pos, *state.vel, state.t.reshape(1)]
    return torch.cat(leaves).contiguous().view(torch.int32)


def physics_kernel_case(state, params, dt, substeps: int, frames: int
                        ) -> dict:
    """The world stepped ``frames`` frames by the physics step kernel and,
    beside it, by the eager step (``physics_step_plain``), both on the card:
    every frame's 7 leaves bit for bit. Returns the frames, the first frame
    whose bits differ (None), the frames after which a pair of spheres
    touched (gap under 1e-4) and the final t."""
    import torch
    from ttrt_torch.kernels import physics as kphysics
    from ttrt_torch.physics import world as pworld

    n = params.radius.shape[0]
    ii, jj = (torch.as_tensor(a, device=state.t.device)
              for a in pworld._pair_indices(n))
    k = p = state
    kernel_rows, plain_rows, touching = [], [], 0
    for _ in range(frames):
        k = kphysics.physics_step_cuda(k, params, dt, substeps)
        p = pworld.physics_step_plain(p, params, dt, substeps)
        kernel_rows.append(physics_bits(k))
        plain_rows.append(physics_bits(p))
        if n > 1:
            touching += int(pair_touching(k, params, ii, jj))
    same = (torch.stack(kernel_rows) == torch.stack(plain_rows)).all(dim=1)
    bad = (~same).nonzero()
    return {"frames": frames,
            "first_mismatch": int(bad[0]) + 1 if len(bad) else None,
            "touching_frames": touching, "t": float(k.t)}


def physics_reference_case(device, frames: int) -> dict:
    """The demo drop stepped ``frames`` frames by ``physics_step`` on
    ``device`` (on the card the physics step kernel) against
    ``benchmark/reference/physics.py``'s own world stepped on the CPU, as
    physics.drop checks its states: every frame's 7 leaves bit for bit.
    Returns the frames, the first frame whose bits differ (None), the
    final t and the reference's seconds."""
    import torch
    from benchmark.reference import physics as ref
    from ttrt_torch.physics import world as pworld

    with open(os.path.join(REPO, "benchmark", "configs",
                           "physics.json")) as f:
        config = json.load(f)
    drop = ref.Drop(config, dtype=torch.float32, device=torch.device("cpu"))
    state, params, dt, substeps = physics_world("demo", device)
    assert substeps == drop.world.substeps
    rows, ref_rows = [], []
    t0 = time.perf_counter()
    for k in range(1, frames + 1):
        ref_rows.append(physics_bits(drop.at(k)))
    ref_s = time.perf_counter() - t0
    for _ in range(frames):
        state = pworld.physics_step(state, params, dt, substeps)
        rows.append(physics_bits(state))
    bad = (~(torch.stack(rows).cpu() == torch.stack(ref_rows)).all(dim=1)
           ).nonzero()
    return {"frames": frames,
            "first_mismatch": int(bad[0]) + 1 if len(bad) else None,
            "t": float(state.t), "reference_s": round(ref_s, 3)}


def physics_state_of(row):
    """The ``PhysicsState`` of a row of ``physics_states``."""
    from ttrt_torch.physics.world import PhysicsState
    from ttrt_torch.vec import Vec3

    n = (row.shape[0] - 1) // 6
    c = row[:-1].reshape(6, n)
    return PhysicsState(Vec3(*c[:3]), Vec3(*c[3:]), row[-1])


def physics_frame_case(scene, cfg, params, state, offset) -> dict:
    """A physics frame (the demo scene, its spheres at ``state``) rendered
    by the frame step through render_frame_cuda and render_frame_plain:
    bit for bit, equal traces."""
    import torch
    from ttrt_torch.kernels import render
    from ttrt_torch.physics import demo

    out = {}
    for name, fn in (("kernel", render.render_frame_cuda),
                     ("plain", render.render_frame_plain)):
        step = demo.build_physics_frame_step(scene, cfg, params, fn,
                                             substeps=0)
        _, fb, rays = step(state, offset, True)
        out[name] = (fb.to_array().cpu().numpy(), rays)
    torch.cuda.synchronize()
    stats = exact_bar(out["plain"][0], out["kernel"][0], out["plain"][1],
                      out["kernel"][1])
    assert stats["max_abs"] == 0.0, stats
    return stats


def physics_states(world: str, device, frames: int):
    """Each frame's state of ``frames`` steps of ``world`` on ``device``:
    a (frames, 7 * n) tensor of pos.x, pos.y, pos.z, vel.x, vel.y, vel.z
    (n each) and t, and the number of frames in which a pair of spheres
    touched (their gap under 1e-4 after the step)."""
    import torch
    from ttrt_torch.physics import world as pworld

    state, params, dt, substeps = physics_world(world, device)
    ii, jj = (torch.as_tensor(a, device=device)
              for a in pworld._pair_indices(params.radius.shape[0]))
    rows, touching = [], torch.zeros((), dtype=torch.int64, device=device)
    for _ in range(frames):
        state = pworld.physics_step(state, params, dt, substeps)
        rows.append(torch.cat([*state.pos, *state.vel, state.t[None]]))
        touching += pair_touching(state, params, ii, jj)
    return torch.stack(rows), int(touching)



def main() -> int:
    import argparse

    import torch

    cli = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    cli.add_argument("--parent", default="", help="a parent checkout: "
                     "phase D times its fused kernel against this one's")
    parent = cli.parse_args().parent
    parent = os.path.abspath(parent) if parent else ""

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
    from ttrt_torch.bench import _kernel_ms, _median_ms
    from ttrt_torch.config import RenderConfig
    from ttrt_torch.frames import orbit_camera_frame
    from ttrt_torch.kernels import build
    from ttrt_torch.kernels.render import (render_frame_cuda,
                                           render_frame_plain, render_layout)
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
    # the launch shapes the full frames do not take, at reduced sizes
    for case in RENDER_CASES:
        stats = render_case(dev, case)
        print(f"phase 2: {case.label}: {json.dumps(stats)}")
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
    kernel_device_ms, kernel_how = _kernel_ms(
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
          f"{rays / plain_ms / 1e3:.1f} Mray/s (plain); the kernel "
          f"{kernel_device_ms:.4f} ms of device time ({kernel_how})")
    print(f"phase 4: render kernel's launch: "
          f"{json.dumps(render_layout(scene, full))}")
    for line in _ptxas_lines(report, "render_kernel"):
        print(f"phase 4: ptxas: {line}")
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
    batch_launches = runtime_phase(card, dev, full)
    render_bound = demo_bound(rays, full.width * full.height)
    kernels = [{
        "name": "render",
        "route": "cuda",
        "source": "ttrt_torch/kernels/csrc/render.cu",
        "replaces": "ttrt/kernels/render_pallas.py:894",
        # phase 5's one frame a step, and phase RT's --batch 8 main path
        "launches": launches + batch_launches,
        "max_abs_err": max_abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": render_bound[0],
        "bound_by": render_bound[1],
        "library_ms": None,  # no single PyTorch call renders a frame
    }]
    mesh_kernels, fused_work = mesh_phases(card, dev, full, report, parent)
    kernels += mesh_kernels
    kernels.append(pathtrace_phases(card, dev, full, report))
    kernels.append(pathtrace_mesh_phases(card, dev, full, report))
    kernels += sky_phases(card, dev, full, fused_work, report)
    kernels += mesh_axis_phases(card, dev, full)
    kernels += scene_phases(card, dev, full)
    bench_launches = bench_phase(card, dev)
    for entry in kernels:
        entry["launches"] += bench_launches.get(entry["name"], 0)

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


RT_BATCH = 8
RT_ROUNDS = 3
RT_PROFILE_FRAMES = 5
RT_SUBSET = 4096


def _host_ms(fn, reps: int = 20) -> float:
    """Median host-clock time of ``fn`` over ``reps`` calls, each after a
    synchronize and ending in one, in ms."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return 1e3 * statistics.median(times)


def _trace_kernels(path: str) -> tuple:
    """(CUDA kernels, render_kernel launches) in a torch.profiler Chrome
    trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e.get("name", "") for e in events
               if e.get("cat") == "kernel"]
    return len(kernels), sum("render_kernel" in n for n in kernels)


def runtime_phase(card: str, dev, full) -> int:
    """Phase RT; returns the render kernel's launches on the --batch main
    path."""
    import torch

    from ttrt_torch import app, assets, native
    from ttrt_torch.frames import orbit_camera_frame
    from ttrt_torch.kernels import mesh, mesh_fused
    from ttrt_torch.kernels.render import (render_frame_cuda,
                                           render_frame_plain)
    from ttrt_torch.mesh.clusters import pack_clusters
    from ttrt_torch.mesh.dense import dense_nearest
    from ttrt_torch.mesh.scene import many_sphere_scene
    from ttrt_torch.render.integrator import generate_rays
    from ttrt_torch.scene import demo_scene
    from ttrt_torch.term.encoder import (ansi_template, encode_ansi_frame,
                                         encode_ansi_host, encode_rgb_frame)
    from ttrt_torch.utils.profiling import TRACE_FILE, StageTimers
    from ttrt_torch.vec import Vec3

    t_phase = time.perf_counter()

    def lap() -> str:
        return f"phase RT at {time.perf_counter() - t_phase:.1f} s"

    # -- the native library and --encode auto --------------------------------
    assert native.available, "the native library did not build"
    lib = os.path.relpath(native.library_path, REPO)
    assert lib.startswith(os.path.join("ttrt_torch", "_build")), lib
    assert app.resolve_encode("auto") == "host"
    print(f"phase RT: native library {lib}; --encode auto -> host")

    # -- three encoders, byte for byte ---------------------------------------
    sky = assets.load_skybox("colors", device=dev)
    demo = demo_scene(sky, full.width, full.height, dtype=torch.float32,
                      device=dev)
    template = ansi_template(full.width, full.height, dev)
    enc = native.NativeAnsiEncoder(full.height, full.width)
    for t in (0.0, 1.5, 3.3):
        fb, _ = render_frame_cuda(demo.with_camera_frame(orbit_camera_frame(
            t, dtype=torch.float32, device=dev)), full, count_rays=False)
        rgb = encode_rgb_frame(fb).cpu().numpy()
        on_card = encode_ansi_frame(fb, template).cpu().numpy().tobytes()
        native_bytes = enc.encode(rgb).tobytes()
        assert native_bytes == on_card == encode_ansi_host(rgb), t
        print(f"phase RT: t={t}: native, on-card and NumPy encodes equal, "
              f"{len(native_bytes)} bytes")

    # -- the batch step against the single step ------------------------------
    zero = torch.zeros(3, device=dev)
    frames = app.build_frame_batch_step(demo, full, RT_BATCH)(
        1.5, zero).cpu()
    single = app.build_frame_step(demo, full, "host")
    ts = (torch.tensor(1.5) + torch.arange(RT_BATCH, dtype=torch.float32)
          * torch.tensor(full.frame_duration)).tolist()
    for k, t in enumerate(ts):
        assert torch.equal(frames[k], single(t, zero).cpu()), (k, t)
    print(f"phase RT: build_frame_batch_step(batch={RT_BATCH}) at t0=1.5 "
          f"equals build_frame_step(encode='host') at t0 + k/fps, bit for "
          f"bit, {RT_BATCH} frames ({lap()})")

    # -- the loops in turns --------------------------------------------------
    unpaced = full.with_(frame_rate=1e9)
    modes = {"--encode device": {"encode": "device"},
             "--encode host": {"encode": "host"},
             f"--batch {RT_BATCH}": {"batch": RT_BATCH}}
    runs = {name: [] for name in modes}
    batch_launches = None
    for round_ in range(RT_ROUNDS):
        for name, kw in modes.items():
            sink, timers = io.BytesIO(), StageTimers()
            render_frame_cuda.launches = 0
            render_frame_plain.launches = 0
            t0 = time.perf_counter()
            app.run_animation(unpaced, "colors", max_frames=N_FRAMES,
                              interactive=False, device=dev, stream=sink,
                              timers=timers, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if round_ == 0:  # each stream is 200 MB: the first round only
                validate_stream(sink.getvalue(), full.width, full.height,
                                N_FRAMES)
            assert render_frame_plain.launches == 0
            if "batch" in kw:
                # issued < frames + batch, with 3 batches in flight
                want = -(-(N_FRAMES + RT_BATCH) // RT_BATCH) * RT_BATCH
                assert render_frame_cuda.launches == want, (
                    render_frame_cuda.launches, want)
                batch_launches = render_frame_cuda.launches
            else:
                assert render_frame_cuda.launches == N_FRAMES
            split = {n: round(st["mean_ms"], 4)
                     for n, st in timers.summary().items()}
            runs[name].append((N_FRAMES / wall, split))
    for name, rs in runs.items():
        fps, split = sorted(rs, key=lambda r: r[0])[len(rs) // 2]
        print(f"phase RT [{card}]: {name}: {N_FRAMES} frames, pacing off, "
              f"median of {RT_ROUNDS} rounds in turns {fps:.2f} fps (all "
              f"{[round(r[0], 2) for r in rs]}; host clock), that round's "
              f"stage means (ms) {json.dumps(split)}")
    print(f"phase RT: --batch {RT_BATCH} main path: render_kernel launched "
          f"{batch_launches} times for {N_FRAMES} frames (the loop issues "
          f"while issued < frames + batch), plain version 0")
    fb, _ = render_frame_cuda(demo, full, count_rays=False)
    rgb_dev = encode_rgb_frame(fb)
    rgb = rgb_dev.cpu().numpy()
    enc_ms = _host_ms(lambda: enc.encode(rgb))
    copy_ms = _host_ms(lambda: rgb_dev.cpu())
    batch_dev = app.build_frame_batch_step(demo, full, RT_BATCH)(1.5, zero)
    batch_copy_ms = _host_ms(lambda: batch_dev.cpu())
    print(f"phase RT [{card}]: native encode of one frame alone "
          f"{enc_ms:.4f} ms; copy of the {rgb.nbytes}-byte RGB frame "
          f"{copy_ms:.4f} ms, of a batch of {RT_BATCH} "
          f"({batch_dev.numel()} bytes) {batch_copy_ms:.4f} ms (host clock, "
          f"medians of 20) ({lap()})")

    # -- --profile -----------------------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        started = {}
        for encode in ("auto", "device"):
            prof = os.path.join(tmp, f"prof_{encode}")
            started[encode] = (prof, _cli_start(
                ["--frames", str(RT_PROFILE_FRAMES), "--no-input",
                 "--encode", encode, "--profile", prof],
                os.path.join(tmp, f"out_{encode}.bin")))
        for encode, (prof, proc) in started.items():
            _, data, wall = _cli_end(proc)
            validate_stream(data, full.width, full.height,
                            RT_PROFILE_FRAMES)
            n_kernels, n_render = _trace_kernels(
                os.path.join(prof, TRACE_FILE))
            head = (f"phase RT: python -m ttrt_torch --frames "
                    f"{RT_PROFILE_FRAMES} --encode {encode} --profile DIR "
                    f"({wall:.1f} s): the trace is written")
            if n_kernels == 0:  # CUPTI's events are not always delivered
                print(f"{head}, with no CUDA events: kernels a frame not "
                      f"measured")
                continue
            assert n_render == RT_PROFILE_FRAMES, n_render
            print(f"{head} and holds {n_kernels} CUDA kernels = "
                  f"{n_kernels / RT_PROFILE_FRAMES:.1f} a frame (set-up "
                  f"included), render_kernel {n_render} (once a frame) "
                  f"({lap()})")

    # -- --debug-nans --------------------------------------------------------
    walls = {False: [], True: []}
    for debug in (False, True, True, False):
        t0 = time.perf_counter()
        app.run_animation(unpaced, "colors", max_frames=N_FRAMES,
                          interactive=False, device=dev,
                          stream=io.BytesIO(), debug_nans=debug)
        torch.cuda.synchronize()
        walls[debug].append(time.perf_counter() - t0)
    check = app._finite_check(True)
    check_ms = _host_ms(lambda: check(fb, 1.5))
    per_frame = 1e3 * (sum(walls[True]) - sum(walls[False])) / (
        2 * N_FRAMES)
    print(f"phase RT [{card}]: --debug-nans: {N_FRAMES} frames pass; "
          f"the loop {per_frame:+.4f} ms a frame against without (in turns, "
          f"host clock), the check alone {check_ms:.4f} ms (host clock, "
          f"median of 20, after a synchronize) ({lap()})")

    # -- the grid, and with_spheres on the card ------------------------------
    for n in (N_SPHERES, 100_000):
        t0 = time.perf_counter()
        scene = many_sphere_scene(sky, n, full.width, full.height,
                                  dtype=torch.float32, device=dev)
        torch.cuda.synchronize()
        print(f"phase RT [{card}]: many_sphere_scene({n}) with its grid "
              f"{tuple(scene.grid.cells.shape)} and cluster pack: "
              f"{time.perf_counter() - t0:.3f} s (host clock)")
    scene = many_sphere_scene(sky, N_SPHERES, full.width, full.height,
                              dtype=torch.float32, device=dev)
    offset = np.random.default_rng(12).uniform(
        -0.5, 0.5, (3, N_SPHERES)).astype(np.float32)
    moved = scene.spheres._replace(center=Vec3(*(
        v + torch.as_tensor(w, device=dev)
        for v, w in zip(scene.spheres.center, offset))))
    t0 = time.perf_counter()
    moved_scene = scene.with_spheres(moved)
    torch.cuda.synchronize()
    rebuild_s = time.perf_counter() - t0
    fresh = pack_clusters(moved, scene.triangles)
    assert moved_scene.grid is None
    for got, want in ((moved_scene.clusters, fresh),
                      (moved_scene.clusters.tables, fresh.tables)):
        for a, b in zip(got, want):
            if isinstance(a, torch.Tensor):
                assert a.device == b.device and a.dtype == b.dtype
                assert a.cpu().numpy().tobytes() == b.cpu().numpy().tobytes()
            elif not hasattr(a, "_fields"):
                assert a == b
    assert not torch.equal(moved_scene.clusters.sph, scene.clusters.sph)
    at = moved_scene.with_camera_frame(orbit_camera_frame(
        3.3, dtype=torch.float32, device=dev))
    o, d = generate_rays(at, full)
    pick = torch.as_tensor(np.random.default_rng(13).choice(
        o.x.numel(), RT_SUBSET, replace=False), device=dev)
    o = Vec3(*(v.reshape(-1)[pick] for v in o))
    d = Vec3(*(v.reshape(-1)[pick] for v in d))
    mesh.cluster_nearest_cuda.launches = 0
    hit = mesh.cluster_nearest_cuda(moved_scene.clusters, o, d)
    ref = dense_nearest(moved, scene.triangles, o, d)
    assert mesh.cluster_nearest_cuda.launches == 1
    assert torch.equal(hit.obj, ref.obj), int((hit.obj != ref.obj).sum())
    assert torch.equal(hit.t, ref.t)
    n_hits = int((hit.obj >= 0).sum())
    print(f"phase RT: with_spheres ({N_SPHERES} spheres moved by a seeded "
          f"offset in "
          f"[-0.5, 0.5)): the pack rebuilt in {rebuild_s:.3f} s equals a "
          f"fresh pack_clusters byte for byte; cluster_nearest_cuda on "
          f"{RT_SUBSET} of its primary rays (t=3.3): ids equal to the dense "
          f"tester's ({n_hits} hits), t bit for bit")
    counters = (mesh_fused.render_band_mesh_fused_cuda,
                mesh_fused.render_band_mesh_fused_plain,
                mesh.cluster_nearest_cuda, mesh.cluster_nearest_plain)
    unpaced = full.with_(frame_rate=1e9)
    for renderer, frames in (("auto", 5), ("eager", 1)):
        for fn in counters:
            fn.launches = 0
        sink = io.BytesIO()
        t0 = time.perf_counter()
        app.run_animation(unpaced, "colors", max_frames=frames,
                          interactive=False, scene=moved_scene, stream=sink,
                          renderer=renderer)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        validate_stream(sink.getvalue(), full.width, full.height, frames)
        counts = [fn.launches for fn in counters]
        assert counts[1] == counts[3] == 0, counts
        assert counts[0] == (frames if renderer == "auto" else 0), counts
        assert (counts[2] > 0) == (renderer == "eager"), counts
        print(f"phase RT [{card}]: the moved scene through run_animation "
              f"--renderer {renderer}: {frames} frames in {wall:.3f} s; "
              f"launches fused {counts[0]}, cluster_nearest {counts[2]}, "
              f"plain versions 0 ({lap()})")
    torch.cuda.synchronize()
    return batch_launches


def parent_phase(card: str, parent: str, scenes, full, report: str) -> None:
    """Phase D with a parent checkout: the fused kernel alone at each of
    ``scenes``, the parent's and this checkout's in one process in turns
    (parent, change, change, parent), after both frames are found equal
    bit for bit; and the ptxas lines of the two other many-object kernels
    in both builds, which must be equal line for line."""
    import torch

    from ttrt_torch.bench import _kernel_ms
    from ttrt_torch.kernels import mesh_fused

    sides = {"parent": parent_call(parent, "ttrt_torch.kernels.mesh_fused",
                                   "render_band_mesh_fused_cuda"),
             "change": mesh_fused.render_band_mesh_fused_cuda}
    for scene in scenes:
        fb = {k: fn(scene, full) for k, fn in sides.items()}
        assert all(torch.equal(a, b) for a, b in zip(*(
            [*v[0], v[1]] for v in fb.values()))), "parent != change"
        ms = {k: [] for k in sides}
        for side in ("parent", "change", "change", "parent"):
            ms[side].append(_kernel_ms(lambda: sides[side](scene, full),
                                       "mesh_fused_kernel", reps=5)[0])
        print(f"phase D [{card}]: fused kernel alone at "
              f"{scene.spheres.count} spheres, in turns (torch.profiler, "
              f"means of 5), parent {ms['parent']} ms, change "
              f"{ms['change']} ms; the frames bit for bit equal")
    _, parent_report = parent_module(
        parent, "ttrt_torch.kernels.build").build()
    unnamed = re.compile(r"_GLOBAL__N__[0-9a-f]+_\d+_mesh_cu_[0-9a-f]{8}")
    for name in ("pathtrace_mesh_kernel", "cluster_nearest_kernel"):
        lines = [[unnamed.sub("", line) for line in _ptxas_lines(r, name)]
                 for r in (parent_report, report)]
        assert lines[0] == lines[1] and lines[0], (name, lines)
        print(f"phase D: {name}'s ptxas lines equal the parent's: "
              f"{json.dumps(lines[1])}")


def mesh_phases(card: str, dev, full, report: str,
                parent: str = "") -> tuple:
    """Phases A-E; returns the two mesh kernels' entries of the kernels
    line, and phase D's fused frame (its scene time and traces).
    ``report`` is phase 1's compiler report; ``parent``, a parent
    checkout to time the fused kernel against (``parent_phase``), or
    empty."""
    import torch

    from ttrt_torch import app, assets
    from ttrt_torch.bench import _kernel_ms, _median_ms
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
    # the launch shapes the full frames do not take, at reduced sizes
    for case in FUSED_CASES:
        stats = fused_case(dev, case)
        print(f"phase A: {case.label}: {json.dumps(stats)}")

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
    # the eager integrator's own batches (full length, dead rays included)
    calls = eager_batches(scene, full)
    batches = {"primary": calls[0], "bounce 3": calls[9],
               "shadow": calls[2]}
    n_calls = len(calls)
    del calls
    plain_hits = {}
    for label, (ob, db) in batches.items():
        plain_hits[label] = mesh.cluster_nearest_plain(pack, ob, db)
        stats = nearest_bar(plain_hits[label],
                            mesh.cluster_nearest_cuda(pack, ob, db))
        nearest_err = max(nearest_err, stats["max_abs_t"])
        print(f"phase B: the eager frame's {label} batch (of {n_calls}), "
              f"vs cluster_nearest_plain: {json.dumps(stats)}")
    stats = nearest_case(dev, 240_000)
    print(f"phase B: 240000 spheres, 64x32x2 primary rays vs the dense "
          f"tester: {json.dumps(stats)}")
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
    fused_kernel_ms, fused_how = _kernel_ms(lambda: fused_cuda(scene, full),
                                            "mesh_fused_kernel", reps=5)
    fused_plain_ms = _median_ms(lambda: fused_plain(scene, full), reps=1,
                                warmup=0)
    table_bytes = sum(v.numel() * v.element_size() for v in pack.tables
                      if isinstance(v, torch.Tensor))
    boxes = quarter_work(pack)
    n_quarters = boxes[0].shape[0]
    work = frame_work(scene, full, boxes)
    assert work["traces"] == work["plain_traces"] == rays, (work, rays)
    fused_work = {"t": 3.3, "rays": rays}
    per_kind = {k: [work[k][0], round(work[k][1] / max(work[k][0], 1), 2)]
                for k in ("primary", "bounce", "shadow")}
    print(f"phase D [{card}]: fused kernel, 480x280x10spp, 10 bounces, "
          f"{N_SPHERES} spheres: {rays} traces; wrapper {fused_ms:.4f} "
          f"ms/frame = {rays / fused_ms / 1e3:.1f} Mray/s (CUDA events, "
          f"median of 20), kernel {fused_kernel_ms:.4f} ms ({fused_how}), "
          f"plain version {fused_plain_ms:.3f} "
          f"ms; no bound: the flat sweep's ({n_quarters} slab tests a "
          f"trace) is no floor for the tree walk, whose own is not counted "
          f"(the walk's work: walk_work below); the flat sweep's floor of "
          f"narrow tests on every trace of the frame, [traces, mean a "
          f"trace] by kind: {json.dumps(per_kind)}; "
          f"{work['narrow_ops']:.6e} narrow-test operations)")
    shape = mesh_fused.fused_layout(scene, full)
    print(f"phase D: fused kernel's launch at {N_SPHERES} spheres: "
          f"{json.dumps(shape)}")
    for line in _ptxas_lines(report):
        print(f"phase D: ptxas: {line}")
    # the walk's own work on the frame's traces (walk_work): the flat sweep
    # in the frame's visit order, as the kernel walked before its tree,
    # against the tree walk; the same hits and blockers
    order = mesh_fused.order_subclusters(pack, scene.camera.frame.origin)
    traces = fused_batches(scene, full, 3, shape["pixels_per_block"])
    for kind, batch in traces.items():
        shadow = kind.startswith("shadow")
        n_b = batch[0].x.numel()
        got, found = {}, []
        for label, tree in (("flat", False), ("tree", True)):
            walk = walk_work(pack, batch[0], batch[1], tree=tree,
                             order=None if tree else order, shadow=shadow,
                             tmax=batch[2] if shadow else None,
                             warp=batch[-1])
            found.append(walk["blocked"] if shadow else walk["hit"].obj)
            got[label] = {
                "slab": round(walk["lane_slabs"] / n_b, 2),
                "narrow": round(walk["lane_tests"] / n_b, 2),
                "slab_simt": round(walk["slab_simt"], 4),
                "narrow_simt": round(walk["simt"], 4)}
        assert torch.equal(found[0], found[1]), kind
        print(f"phase D [{card}]: the fused frame's {kind} rays ({n_b}; "
              f"bounce: bounce 3's, shadow: the primary hits'), walk_work "
              f"a trace, flat sweep against tree walk (the same "
              f"{'blockers' if shadow else 'hits'}): {json.dumps(got)}")
    del traces
    streams = [torch.cuda.Stream() for _ in range(full.rays_per_pixel)]
    bands = [(lambda k=k: fused_cuda(scene, full, sample_offset=float(k),
                                     n_samples=1, reduce="sum"))
             for k in range(full.rays_per_pixel)]
    on_streams(streams, bands)
    one_ms = _median_ms(lambda: fused_cuda(scene, full), reps=3, warmup=0)
    set_ms = _median_ms(lambda: on_streams(streams, bands), reps=3,
                        warmup=0)
    one_band_ms, one_band_how = _kernel_ms(bands[0], "mesh_fused_kernel",
                                           reps=3)
    print(f"phase D [{card}]: the same frame as {len(bands)} one-sample sum "
          f"bands on as many streams {set_ms:.4f} ms against one launch "
          f"{one_ms:.4f} ms ({set_ms / one_ms:.3f}; CUDA events, medians "
          f"of 3); one such band {one_band_ms:.4f} ms ({one_band_how})")

    n_rays = o.x.numel()
    near_ms = _median_ms(lambda: mesh.cluster_nearest_cuda(pack, o, d))
    dense_ms = _median_ms(
        lambda: dense_nearest(scene.spheres, scene.triangles, o, d), reps=3,
        warmup=1)
    print(f"phase D [{card}]: cluster_nearest on the {n_rays} primary rays: "
          f"wrapper {near_ms:.4f} ms = {n_rays / near_ms / 1e3:.1f} Mray/s "
          f"(CUDA events, median of 20), dense tester {dense_ms:.3f} ms; "
          f"launch {json.dumps(mesh.nearest_layout(n_rays))}")
    for line in _ptxas_lines(report, "cluster_nearest_kernel"):
        print(f"phase D: ptxas: {line}")
    # each batch: the kernel alone, its bound (narrow_work's floor) and the
    # walk's own work (walk_work, equal to the kernel and the plain version)
    for label, (ob, db) in batches.items():
        hit = mesh.cluster_nearest_cuda(pack, ob, db)
        alone_ms, alone_how = _kernel_ms(
            lambda: mesh.cluster_nearest_cuda(pack, ob, db),
            "cluster_nearest_kernel")
        objs, ops = narrow_work(boxes, ob, db, hit.t)
        n_b = ob.x.numel()
        bound = bound_ms(n_b * n_quarters * SLAB_OPS + float(ops),
                         table_bytes + 32 * n_b)
        walk = walk_work(pack, ob, db)
        nearest_bar(hit, walk["hit"])
        nearest_bar(plain_hits[label], walk["hit"])
        if label == "primary":
            near_bound = bound
        print(f"phase D [{card}]: cluster_nearest, the eager frame's {label} "
              f"batch ({n_b} rays, {int((hit.obj >= 0).sum())} hits): kernel "
              f"{alone_ms:.4f} ms ({alone_how}); bound "
              f"{bound[0]:.4f} ms by {bound[1]} ({n_quarters} slab tests and "
              f"{float(objs) / n_b:.2f} narrow tests a ray, the floor); the "
              f"index-order walk makes {walk['lane_tests'] / n_b:.2f} narrow "
              f"tests a ray ({walk['lane_tests'] / float(objs):.3f}x the "
              f"floor), its warps of 32 rays issue "
              f"{walk['warp_tests'] / ((n_b + 31) // 32):.2f} a warp, SIMT "
              f"efficiency {walk['simt']:.4f}; the walk's replay equals the "
              f"kernel and cluster_nearest_plain bit for bit")

    big = scene_at(3.3, n=100_000)
    _, big_rays = fused_cuda(big, full)
    big_ms = _median_ms(lambda: fused_cuda(big, full), reps=5, warmup=1)
    big_kernel_ms, big_how = _kernel_ms(lambda: fused_cuda(big, full),
                                        "mesh_fused_kernel", reps=3)
    print(f"phase D [{card}]: fused kernel at 100000 spheres: "
          f"{int(big_rays)} traces, wrapper {big_ms:.4f} ms/frame = "
          f"{int(big_rays) / big_ms / 1e3:.1f} Mray/s (median of 5), kernel "
          f"{big_kernel_ms:.4f} ms ({big_how}); "
          f"launch {json.dumps(mesh_fused.fused_layout(big, full))}")
    if parent:
        parent_phase(card, parent, (scene, big), full, report)
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
        "bound_ms": None,  # the tree walk's floor is not counted
        "bound_by": None,
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


def pathtrace_phases(card: str, dev, full, report: str) -> dict:
    """Phases P1-P4; returns the path-tracing kernel's entry of the
    kernels line. ``report`` is phase 1's nvcc report."""
    import torch

    from ttrt_torch import app, assets
    from ttrt_torch.bench import _kernel_ms, _median_ms
    from ttrt_torch.frames import orbit_camera_frame
    from ttrt_torch.kernels import pathtrace
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
    # the launch shapes the full frames do not take, at reduced sizes
    for case in PATHTRACE_CASES:
        stats = pathtrace_case(dev, case)
        print(f"phase P1: {case.label}: {json.dumps(stats)}")

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
    pt_kernel_ms, pt_how = _kernel_ms(
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
          f"events, median of 20), kernel {pt_kernel_ms:.4f} ms = "
          f"{traces / pt_kernel_ms / 1e3:.1f} Mray/s ({pt_how}), plain version {pt_plain_ms:.3f} ms (median of 3); bound "
          f"{pt_bound[0]:.4f} ms by {pt_bound[1]}")
    print(f"phase P3: path-tracing kernel's launch: "
          f"{json.dumps(pathtrace.pathtrace_layout(scene, lights, full))}")
    for line in _ptxas_lines(report, "pathtrace_kernel"):
        print(f"phase P3: ptxas: {line}")

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


def pathtrace_mesh_phases(card: str, dev, full, report: str) -> dict:
    """Phases PM1-PM4; returns the many-object path tracer's entry of the
    kernels line. ``report`` is phase 1's nvcc report."""
    import torch

    from ttrt_torch import app
    from ttrt_torch.bench import _kernel_ms, _median_ms
    from ttrt_torch.kernels import pathtrace
    from ttrt_torch.kernels.mesh import cluster_nearest_cuda
    from ttrt_torch.render import pathtrace as estimator
    from ttrt_torch.utils.profiling import PATH_STEPS, StageTimers

    pt_cuda = pathtrace.pathtrace_frame_cuda
    pt_plain = pathtrace.pathtrace_frame_plain
    lights = estimator.default_area_lights(full, dev)
    many = pathtrace_mesh_scene(dev, N_SPHERES, full, 0.7)
    seed = pathtrace.frame_seed(0, 0.7)

    # -- phase PM1: the kernel vs its plain version ---------------------------
    t0 = time.perf_counter()
    stats = pathtrace_mesh_rows(many, lights, full, seed, PM_ROWS)
    print(f"phase PM1: 480x280x10spp, 10 bounces, t=0.7, {PM_ROWS} rows in "
          f"{time.perf_counter() - t0:.2f} s: {json.dumps(stats)}")
    for case in PATHTRACE_MESH_CASES:
        t0 = time.perf_counter()
        stats = pathtrace_case(dev, case, mesh=True)
        print(f"phase PM1: {case.label} ({time.perf_counter() - t0:.2f} s): "
              f"{json.dumps(stats)}")

    # -- phase PM2: the kernel vs the eager estimator -------------------------
    fb_k, work = pt_cuda(many, lights, full, seed)
    t0 = time.perf_counter()
    fb_e = estimator.pathtrace_frame(
        many, lights, full, torch.Generator(device=dev).manual_seed(seed))
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    mean_k = float(fb_k.to_array().mean())
    mean_e = float(fb_e.to_array().mean())
    print(f"phase PM2 [{card}]: the eager estimator, one frame in "
          f"{eager_s:.3f} s (host clock): image mean {mean_e:.6f} against "
          f"the kernel's {mean_k:.6f}")
    assert abs(mean_e - mean_k) < PT_ESTIMATOR_MEAN_TOL, (mean_e, mean_k)

    # -- phase PM3: timing ----------------------------------------------------
    traces = pathtrace.total_traces(work, lights.count)
    pm_ms = _median_ms(
        lambda: pt_cuda(many, lights, full, seed, count_rays=False),
        reps=10, warmup=2)
    pm_kernel_ms, pm_how = _kernel_ms(
        lambda: pt_cuda(many, lights, full, seed, count_rays=False),
        "pathtrace_mesh_kernel", reps=5)
    print(f"phase PM3 [{card}]: many-object path tracer, {N_SPHERES} "
          f"spheres, 480x280x10spp, 10 bounces, t=0.7: work (nearest-hit "
          f"traces, hits, unblocked shadow rays) {[int(v) for v in work]} = "
          f"{traces} traces; wrapper {pm_ms:.4f} ms/frame (CUDA events, "
          f"median of 10), kernel {pm_kernel_ms:.4f} ms = "
          f"{traces / pm_kernel_ms / 1e3:.2f} Mray/s ({pm_how}); the eager "
          f"estimator {1e3 * eager_s:.1f} ms (PM2)")
    print(f"phase PM3: its launch: "
          f"{json.dumps(pathtrace.pathtrace_layout(many, lights, full))}")
    for line in _ptxas_lines(report, "pathtrace_mesh_kernel"):
        print(f"phase PM3: ptxas: {line}")

    # -- phase PM4: the --pathtrace --scene many main path --------------------
    for fn in (pt_cuda, pt_plain, cluster_nearest_cuda):
        fn.launches = 0
    sink = io.BytesIO()
    timers = StageTimers()
    t0 = time.perf_counter()
    app.run_animation(full.with_(frame_rate=1e9), "colors",
                      max_frames=PM_FRAMES, interactive=False,
                      encode="device", scene=many, stream=sink,
                      timers=timers, pathtrace=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    validate_stream(sink.getvalue(), full.width, full.height, PM_FRAMES)
    launches = [fn.launches for fn in (pt_cuda, pt_plain,
                                       cluster_nearest_cuda)]
    routes = (PATH_STEPS.kernel, PATH_STEPS.estimator)
    split = {name: round(st["mean_ms"], 4)
             for name, st in timers.summary().items()}
    print(f"phase PM4 [{card}]: --pathtrace --scene many: {PM_FRAMES} "
          f"frames in {wall:.3f} s = {PM_FRAMES / wall:.2f} fps end to end "
          f"(pacing off), stage means (ms) {json.dumps(split)}; launches "
          f"path tracer {launches[0]} (plain {launches[1]}), "
          f"cluster_nearest {launches[2]}; steps by route (kernel, "
          f"estimator) {routes}")
    assert launches == [PM_FRAMES, 0, 0], launches
    assert routes == (PM_FRAMES, 0), routes
    return {
        "name": "pathtrace_mesh",
        "route": "cuda",
        "source": "ttrt_torch/kernels/csrc/mesh.cu",
        "replaces": None,  # JAX path-traces a MeshScene eagerly
        "launches": PM_FRAMES,
        "max_abs_err": 0.0,
        "ms": pm_ms,
        "plain_ms": None,
        "bound_ms": None,
        "bound_by": None,
        "library_ms": None,  # no single PyTorch call renders a frame
    }


def sky_phases(card: str, dev, full, fused_work: dict, report: str) -> list:
    """Phases S1-S6; returns the entries of the kernels line of the
    textured demo and fused kernels, the sky-weight kernel and the
    pixel-rate kernel. ``fused_work`` is phase D's fused frame, whose
    geometry phase S2 renders again under the image sky; ``report`` is
    phase 1's nvcc report."""
    import torch

    from ttrt_torch import app, assets
    from ttrt_torch.bench import _kernel_ms, _median_ms
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
                             *_kernel_ms(run, "render_kernel"))
        print(f"phase S4 [{card}]: demo, milky_way, bilinear={bilinear}, "
              f"480x280x10spp, 10 bounces: {int(rays)} traces; wrapper "
              f"{demo_ms[bilinear][0]:.4f} ms (CUDA events, median of 20), "
              f"kernel {demo_ms[bilinear][1]:.4f} ms ({demo_ms[bilinear][2]})")
    demo_rays = int(render.render_frame_cuda(scene, full)[1])
    demo_plain_ms = _median_ms(
        lambda: render.render_frame_plain(scene, full, count_rays=False),
        reps=5, warmup=1)
    many = many_at(fused_work["t"])
    fused_ms = _median_ms(lambda: fused_cuda(many, full))
    fused_kernel_ms, fused_how = _kernel_ms(lambda: fused_cuda(many, full),
                                            "mesh_fused_kernel", reps=5)
    print(f"phase S4 [{card}]: fused, milky_way, t={fused_work['t']}: "
          f"wrapper {fused_ms:.4f} ms (median of 20), kernel "
          f"{fused_kernel_ms:.4f} ms ({fused_how}), plain version "
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
    sw_kernel_ms, sw_how = _kernel_ms(
        lambda: render.sky_weights_cuda(scene, full), "sky_weight_kernel")
    sw_plain_ms = _median_ms(lambda: sw_plain(scene, full), reps=5,
                             warmup=1)
    print(f"phase S5 [{card}]: sky weights, 480x280x10, 10 bounces, t=1.5: "
          f"{w_k.numel()} rays, {nearest} nearest-hit traces, {sw_diff} "
          f"differ from the plain version (max |d| {sw_err}); wrapper "
          f"{sw_ms:.4f} ms (median of 20), kernel {sw_kernel_ms:.4f} "
          f"ms ({sw_how}), plain version {sw_plain_ms:.3f} ms (median of "
          f"5); bound {sw_bound[0]:.4f} ms by {sw_bound[1]}; launches "
          f"(kernel, plain) in this phase's call {sw_launches}")
    print(f"phase S5: sky-weight kernel's launch: "
          f"{json.dumps(render.sky_weights_layout(scene, full))}")
    for line in _ptxas_lines(report, "sky_weight_kernel"):
        print(f"phase S5: ptxas: {line}")
    for case in SKY_CASES:
        stats = sky_case(dev, case)
        sw_err = max(sw_err, stats["max_abs"])
        print(f"phase S5: {case.label}: {json.dumps(stats)}")

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
            rate_kernel_ms, rate_how = _kernel_ms(lambda: pr_cuda(s6, cfg),
                                                  "render_kernel")
            rate_plain_ms = _median_ms(lambda: pr_plain(s6, cfg), reps=5,
                                       warmup=1)
    rate_bound = demo_bound(rate_rays, n_px)
    print(f"phase S6 [{card}]: pixel rate, colors t=1.5: wrapper "
          f"{rate_ms:.4f} ms (median of 20), kernel "
          f"{rate_kernel_ms:.4f} ms ({rate_how}), plain version "
          f"{rate_plain_ms:.3f} ms (median of 5); bound {rate_bound[0]:.4f} "
          f"ms by {rate_bound[1]}; launches (kernel, plain) in this phase's "
          f"call {rate_launches}")

    demo_bound_img = demo_bound(demo_rays, n_px, texel_bytes)
    print(f"phase S4-S6 [{card}]: bounds: textured demo "
          f"{demo_bound_img[0]:.4f} ms by {demo_bound_img[1]} ({demo_rays} "
          f"traces, {texel_bytes} bytes of texels); textured fused: none, "
          f"as phase D's")
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
              bound_ms=None, bound_by=None),
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
    from ttrt_torch.bench import _kernel_ms, _median_ms
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
    band_ms = _median_ms(run)
    band_kernel_ms, band_how = _kernel_ms(run, "render_kernel")
    band_plain_ms = _median_ms(lambda: render.render_band_plain(
        scene, full, reduce="sum", count_rays=False), reps=3, warmup=1)
    frame_kernel_ms, frame_how = _kernel_ms(
        lambda: render.render_frame_cuda(scene, full, count_rays=False),
        "render_kernel")
    band_bound = demo_bound(int(band_rays), n_px)
    print(f"phase M1 [{card}]: the whole-frame sum band, colors t=1.5: "
          f"wrapper {band_ms:.4f} ms (median of 20), kernel "
          f"{band_kernel_ms:.4f} ms ({band_how}), the average "
          f"(render_frame_cuda) {frame_kernel_ms:.4f} ms ({frame_how}), plain "
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
    pt_ms = _median_ms(pt_run)
    pt_kernel_ms, pt_how = _kernel_ms(pt_run, "pathtrace_kernel")
    pt_mean_kernel_ms, pt_mean_how = _kernel_ms(
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
          f"20), kernel {pt_kernel_ms:.4f} ms ({pt_how}), the mean mode "
          f"{pt_mean_kernel_ms:.4f} ms ({pt_mean_how}), plain "
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


def _hud_fps(stream: bytes) -> list:
    """The fps HUD values (TerminalDisplay.write_fps) of an ANSI stream."""
    return [float(v) for v in re.findall(rb"\x1b\[0;0H([0-9.]+) fps\n",
                                         stream)]


def _cli_start(args: list, out_path: str):
    """Start ``python -m ttrt_torch ARGS`` from this checkout, its stdout
    into ``out_path``; ``_cli_end`` waits for it."""
    env = dict(os.environ, PYTHONPATH=REPO)
    with open(out_path, "wb") as out:
        proc = subprocess.Popen([sys.executable, "-m", "ttrt_torch", *args],
                                cwd=REPO, env=env, stdout=out,
                                stderr=subprocess.PIPE)
    return proc, out_path, time.perf_counter()


def _cli_end(started, timeout: float = 300):
    """(the process, its stderr bytes, its stdout bytes, its wall seconds)
    of a ``_cli_start`` process, once it has exited 0."""
    proc, out_path, t0 = started
    try:
        _, err = proc.communicate(timeout=timeout)
    finally:
        proc.kill()
    wall = time.perf_counter() - t0
    with open(out_path, "rb") as f:
        data = f.read()
    assert proc.returncode == 0, err.decode()[-2000:]
    return err, data, wall


def _cli(args: list, out_path: str, timeout: float = 300):
    """Run ``python -m ttrt_torch ARGS`` to its end: ``_cli_end``'s."""
    return _cli_end(_cli_start(args, out_path), timeout)


class _OpCount:
    """Counts the ATen operations dispatched inside its ``with`` block (on
    the card nearly every one launches a kernel; views launch none)."""

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        counter = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                counter.n += 1
                return func(*args, **(kwargs or {}))

        self.n = 0
        self._mode = Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self._mode.__exit__(*exc)


# the kernels line's entries and the bench's launch counters of their kernels
BENCH_ENTRIES = {"render": "render_frame_cuda",
                 "mesh_fused": "render_band_mesh_fused_cuda",
                 "cluster_nearest": "cluster_nearest_cuda",
                 "pathtrace": "pathtrace_frame_cuda"}


def bench_checks(card: str, dev) -> dict:
    """Phase BN's checks: each kernel the bench's tiers launch against its
    plain version on the same card tensors, at the first time of each
    window with the tier's own config, scene and camera scale: the demo
    (480x280x10x10, t = 2.0, which the loops also render), the image sky
    nearest and bilinear (t = 900), the fused kernel on 10k spheres inside
    the cloud (t = 1300) and from the exterior camera (x20 at 1500, 1533,
    1566) and on 100k (x20 at 2100, 2133, 2166), cluster_nearest on every
    batch of the eager 10k frame at t = 1300, the render kernel on the
    physics frame's scene after its first step (240x64x4x4), the path
    tracer at 240x64x40x4 and x4x4 (t = 1700, the bench's seed). Frames
    bit for bit, equal traces (work), equal hits. Returns the launches
    these comparisons made, by wrapper: they are not the bench's."""
    import torch

    from ttrt_torch import bench
    from ttrt_torch.kernels import mesh, mesh_fused, render
    from ttrt_torch.physics.demo import (build_physics_demo,
                                         build_physics_frame_step)
    from ttrt_torch.render.pathtrace import default_area_lights

    before = {fn.__name__: fn.launches
              for pair in bench.COUNTERS for fn in pair}

    def size(cfg) -> str:
        return (f"{cfg.width}x{cfg.height}x{cfg.rays_per_pixel}x"
                f"{cfg.bounce_limit}")

    def same(label, kernel, plain, scene, cfg):
        label = f"{label} {size(cfg)}"
        fb_k, rays_k = kernel(scene, cfg)
        fb_p, rays_p = plain(scene, cfg)
        torch.cuda.synchronize()
        out = fb_k.to_array().cpu().numpy()
        assert out.shape == (cfg.height, cfg.width, 3), (label, out.shape)
        assert np.isfinite(out).all(), label
        stats = exact_bar(fb_p.to_array().cpu().numpy(), out, rays_p, rays_k)
        assert stats["max_abs"] == 0.0 and stats["diff_px"] == 0, (label,
                                                                   stats)
        print(f"phase BN [{card}]: {label}, kernel vs plain: "
              f"{json.dumps(stats)}")

    first = {tier: base for tier, (base, _) in bench.WINDOWS.items()}
    demo = render.render_frame_cuda, render.render_frame_plain
    cfg = bench.DEMO
    same(f"rays t={first['rays']}", *demo,
         bench.posed(bench._demo(cfg, dev), cfg, first["rays"]), cfg)
    textured = bench.posed(bench.textured_scene(cfg, dev), cfg,
                           first["textured"])
    for bilinear in (False, True):
        same(f"textured bilinear={bilinear} t={first['textured']}", *demo,
             textured, cfg.with_(skybox_bilinear=bilinear))
    del textured

    cfg = bench.MANY
    fused = (mesh_fused.render_band_mesh_fused_cuda,
             mesh_fused.render_band_mesh_fused_plain)
    x = bench.FLYOVER_SCALE
    for n, label in ((10_000, "10k"), (100_000, "100k")):
        scene = bench.many_scene(n, cfg, dev)
        cases = [(t, x) for t in bench.FLYOVER_BASES[label]]
        if label == "10k":
            cases.insert(0, (first["many"], 1.0))
        for t, scale in cases:
            same(f"fused {n} spheres t={t} x{scale:g}", *fused,
                 bench.posed(scene, cfg, t, scale), cfg)
        if label == "10k":
            calls = eager_batches(bench.posed(scene, cfg, first["many"]),
                                  cfg)
            for i, (o, d) in enumerate(calls):
                stats = nearest_bar(
                    mesh.cluster_nearest_plain(scene.clusters, o, d),
                    mesh.cluster_nearest_cuda(scene.clusters, o, d))
                print(f"phase BN [{card}]: cluster_nearest, batch {i} of "
                      f"{len(calls)} of the eager 10k frame at "
                      f"t={first['many']}, kernel vs plain: "
                      f"{json.dumps(stats)}")
            del calls
        del scene

    cfg = bench.PHYSICS
    scene = bench._demo(cfg, dev)
    state, params = build_physics_demo(scene)
    seen = []
    build_physics_frame_step(
        scene, cfg, params,
        lambda s, c, count_rays: seen.append(s) or (None, None))(
            state, torch.zeros(3, dtype=cfg.dtype, device=dev))
    same("physics frame after its first step", *demo, seen[0], cfg)

    t = first["pathtrace"]
    seed = bench.bench_seed(t)
    for cfg in (bench.PATHTRACE, bench.PATHTRACE_TIER):
        stats = pathtrace_exact(
            bench.posed(bench._demo(cfg, dev), cfg, t),
            default_area_lights(cfg, dev), cfg, seed, label="bench")
        print(f"phase BN [{card}]: path tracer t={t} seed {seed} "
              f"{size(cfg)}, kernel vs plain: {json.dumps(stats)}")
    return {fn.__name__: fn.launches - before[fn.__name__]
            for pair in bench.COUNTERS for fn in pair}


def bench_phase(card: str, dev) -> dict:
    """Phase BN: the bench's kernels against their plain versions at its
    shapes (``bench_checks``), then every tier of ttrt_torch.bench once
    (``run(repeats=1)``, which sets the launch counts to 0 first); returns
    the bench's kernel launches by kernels-line entry."""
    from ttrt_torch import bench

    t0 = time.perf_counter()
    checked = bench_checks(card, dev)
    print(f"phase BN [{card}]: the bench's shapes, every kernel equal to "
          f"its plain version bit for bit, in "
          f"{time.perf_counter() - t0:.1f} s; these checks' own launches "
          f"(not counted below): {json.dumps(checked)}")
    t0 = time.perf_counter()
    line, failed = bench.run(repeats=1)
    wall = time.perf_counter() - t0
    print(f"phase BN: the bench's line {json.dumps(line)}")
    errors = {k: v for k, v in line.items() if k.endswith("_error")}
    assert not failed and not errors, errors
    assert not bench.bad_keys(line), bench.bad_keys(line)
    launches = line["launches"]
    for kernel, plain in bench.COUNTERS:
        assert launches[kernel.__name__] > 0, launches
        assert launches[plain.__name__] == 0, launches
    print(f"phase BN [{card}]: python -m ttrt_torch.bench's tiers, one run "
          f"each (repeats=1), in {wall:.1f} s: every key of LINE_KEYS "
          f"finite and > 0, no error; launches, the counts set to 0 before "
          f"and read after, {json.dumps(launches)}: every kernel's > 0, "
          f"every plain version's 0")
    return {entry: launches[name] for entry, name in BENCH_ENTRIES.items()}


def scene_phases(card: str, dev, full) -> list:
    """Phases SF (JSON scene files), PH (the physics tier) and BT (banded
    stills); returns their entries of the kernels line."""
    import torch

    from ttrt_torch import app, assets
    from ttrt_torch.bench import _cuda_kernels, _kernel_ms, _median_ms
    from ttrt_torch.frames import orbit_camera_frame
    from ttrt_torch.kernels import pathtrace, render
    from ttrt_torch.physics import demo, world as pworld
    from ttrt_torch.render import integrator
    from ttrt_torch.render.pathtrace import default_area_lights
    from ttrt_torch.scene import demo_scene
    from ttrt_torch.scenefile import load_scene_file
    from ttrt_torch.term.encoder import encode_rgb_frame
    from ttrt_torch.kernels import build
    from ttrt_torch.utils.profiling import PHYSICS_STEPS, StageTimers

    t_start = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    unpaced = full.with_(frame_rate=1e9)
    n_px = full.width * full.height
    size = ["--width", str(full.width), "--height", str(full.height),
            "--spp", str(full.rays_per_pixel), "--bounces",
            str(full.bounce_limit)]

    def at(scene, t):
        return scene.with_camera_frame(
            orbit_camera_frame(t, dtype=torch.float32, device=dev))

    # -- phase SF: JSON scene files ------------------------------------------
    files = {}
    for sky in ("uv_checker", "milky_way"):
        files[sky] = os.path.join(tmp.name, f"{sky}.json")
        with open(files[sky], "w") as f:
            json.dump({**SCENE_FILE, "skybox": sky}, f)
    scenes = {sky: load_scene_file(path, full.width, full.height,
                                   device=dev)
              for sky, path in files.items()}
    counts = (scenes["uv_checker"].spheres.count,
              scenes["uv_checker"].directional_lights.count,
              scenes["uv_checker"].point_lights.count)
    assert counts == (9, 2, 1), counts  # the point light: a black stand-in
    sf_err = {"uv_checker": 0.0, "milky_way": 0.0, "pathtrace": 0.0}
    sf_rays = {}
    for sky, t in (("uv_checker", 0.0), ("uv_checker", 2.1),
                   ("milky_way", 2.1)):
        stats = file_scene_case(at(scenes[sky], t), full)
        sf_err[sky] = max(sf_err[sky], stats["max_abs"])
        sf_rays[sky] = stats["rays"]
        print(f"phase SF: scene file, 9 spheres, 2 + 0 lights, ground y=-1, "
              f"{sky} t={t}: render kernel vs plain {json.dumps(stats)}")
    for t in (0.7, 3.3):
        seed = pathtrace.frame_seed(0, t)
        stats = file_pathtrace_case(at(scenes["uv_checker"], t), full, seed)
        sf_err["pathtrace"] = max(sf_err["pathtrace"], stats["max_abs"])
        sf_work = stats["work"]
        print(f"phase SF: scene file, uv_checker t={t} seed={seed}: "
              f"path-tracing kernel vs plain {json.dumps(stats)}")

    # timing of the kernels on the file scene, t = 2.1 (0.7 for --pathtrace)
    sf_ms, sf_plain_ms = {}, {}
    for sky in ("uv_checker", "milky_way"):
        s = at(scenes[sky], 2.1)
        sf_ms[sky] = _median_ms(
            lambda: render.render_frame_cuda(s, full, count_rays=False))
        sf_plain_ms[sky] = _median_ms(
            lambda: render.render_frame_plain(s, full, count_rays=False),
            reps=5, warmup=1)
    lights = default_area_lights(full, dev)
    s = at(scenes["uv_checker"], 3.3)
    seed = pathtrace.frame_seed(0, 3.3)
    sf_ms["pathtrace"] = _median_ms(lambda: pathtrace.pathtrace_frame_cuda(
        s, lights, full, seed, count_rays=False))
    sf_plain_ms["pathtrace"] = _median_ms(
        lambda: pathtrace.pathtrace_frame_plain(s, lights, full, seed,
                                                count_rays=False),
        reps=3, warmup=1)
    texel_bytes = 4 * scenes["milky_way"].skybox.packed.numel()
    sf_bound = {
        sky: demo_bound(sf_rays[sky], n_px,
                        texel_bytes if sky == "milky_way" else 0, 9, 2, 1)
        for sky in ("uv_checker", "milky_way")}
    sf_bound["pathtrace"] = bound_ms(
        pathtrace_ops(sf_work, 9, lights.count,
                      n_px * full.rays_per_pixel),
        4 * (17 + 9 * 9 + 16 + 8 * lights.count) + 20 * n_px)
    for key in sf_ms:
        print(f"phase SF [{card}]: scene file, {key}: wrapper "
              f"{sf_ms[key]:.4f} ms (CUDA events, median of 20), plain "
              f"version {sf_plain_ms[key]:.3f} ms; bound "
              f"{sf_bound[key][0]:.4f} ms by {sf_bound[key][1]}")

    # the main paths of a file scene, each with the launch counts set to 0
    # before and read after
    counters = (render.render_frame_cuda, render.render_frame_plain,
                pathtrace.pathtrace_frame_cuda,
                pathtrace.pathtrace_frame_plain)
    launches = {}
    for name, sky, frames, kw in (
            ("file", "uv_checker", N_FRAMES, {}),
            ("file milky_way", "milky_way", 10, {}),
            ("file pathtrace", "uv_checker", 10, {"pathtrace": True})):
        sink = io.BytesIO()
        timers = StageTimers()
        for fn in counters:
            fn.launches = 0
        t0 = time.perf_counter()
        app.run_animation(unpaced, "colors", max_frames=frames,
                          interactive=False, encode="device", stream=sink,
                          timers=timers, scene=scenes[sky], **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[name] = [fn.launches for fn in counters]
        validate_stream(sink.getvalue(), full.width, full.height, frames)
        split = {k: round(st["mean_ms"], 4)
                 for k, st in timers.summary().items()}
        print(f"phase SF [{card}]: --scene-file ({sky}) {name}: {frames} "
              f"frames in {wall:.3f} s = {frames / wall:.2f} fps end to end "
              f"(pacing off), stage means (ms) {json.dumps(split)}; "
              f"launches render {launches[name][:2]}, pathtrace "
              f"{launches[name][2:]} (kernel, plain)")
    assert launches["file"] == [N_FRAMES, 0, 0, 0], launches
    assert launches["file milky_way"] == [10, 0, 0, 0], launches
    assert launches["file pathtrace"] == [0, 0, 10, 0], launches

    # the CLI, each command a process of its own, the three at once
    still = os.path.join(tmp.name, "still.ppm")
    runs = [_cli_start([*size, "--scene-file", files["uv_checker"],
                        "--still", still, "--time", "2.1"],
                       os.path.join(tmp.name, "still.out")),
            _cli_start([*size, "--scene-file", files["uv_checker"],
                        "--frames", "30", "--no-input"],
                       os.path.join(tmp.name, "frames.out")),
            _cli_start(["--show-skybox", "colors", "--width", "30"],
                       os.path.join(tmp.name, "sky.out"))]
    _, _, wall = _cli_end(runs[0])
    img = assets.read_ppm(still)
    assert img.shape == (full.height, full.width, 3) and img.std() > 0, (
        img.shape)
    ref = encode_rgb_frame(render.render_frame_cuda(
        at(scenes["uv_checker"], 2.1), full)[0]).cpu().numpy()
    assert np.array_equal(img, ref)
    print(f"phase SF: --scene-file F --still out.ppm: {img.shape[1]}x"
          f"{img.shape[0]}, equal to the kernel's frame, {wall:.1f} s")
    _, data, wall = _cli_end(runs[1])
    validate_stream(data, full.width, full.height, 30)
    hud = _hud_fps(data)
    print(f"phase SF [{card}]: python -m ttrt_torch --scene-file F --frames "
          f"30 --no-input (paced to 60 fps): stream valid, HUD fps median "
          f"{statistics.median(hud):.2f} (of {len(hud)}), process "
          f"{wall:.1f} s")
    _, data, wall = _cli_end(runs[2])
    cells = re.findall(rb"\x1b\[48;2;(\d+);(\d+);(\d+)m  ", data)
    assert len(cells) > 30 and len(set(cells)) == 6, (len(cells),
                                                      set(cells))
    print(f"phase SF: --show-skybox colors --width 30: {len(cells)} "
          f"truecolor cells, 6 colors, {wall:.1f} s")
    print(f"phase SF: {time.perf_counter() - t_start:.1f} s")

    # -- phase PH: the physics tier ------------------------------------------
    t_ph = time.perf_counter()
    cpu = torch.device("cpu")

    # the CLI with a checkpoint: a second process resumes at the saved t.
    # Each process steps a few frames; the first runs beside the drop's
    # checks below, the second beside the head-on world's
    ckpt = os.path.join(tmp.name, "state.ckpt")

    def ckpt_start(run):
        return _cli_start([*size, "--scene", "physics", "--frames",
                           str(CKPT_FRAMES), "--no-input", "--checkpoint",
                           ckpt], os.path.join(tmp.name, f"physics{run}.out"))

    def ckpt_end(run, started):
        err, data, wall = _cli_end(started)
        validate_stream(data, full.width, full.height, CKPT_FRAMES)
        with np.load(ckpt + ".npz") as saved:
            t_saved = float(saved["arr_6"])
        # each run steps CKPT_FRAMES frames of frame_duration seconds
        run_t = CKPT_FRAMES * full.frame_duration
        assert abs(t_saved - run * run_t) < 1e-5, (run, t_saved)
        if run == 2:
            assert f"resumed physics state at t={run_t:.2f}s".encode() in (
                err), err.decode()[-500:]
        print(f"phase PH [{card}]: python -m ttrt_torch --scene physics "
              f"--frames {CKPT_FRAMES} --no-input --checkpoint C (run {run}):"
              f" stream valid, HUD fps {_hud_fps(data)}, saved t={t_saved}, "
              f"process {wall:.1f} s")

    ph = {}
    cli_run = ckpt_start(1)
    for world, frames in (("demo", 120), ("head-on", 40)):
        a, touch_a = physics_states(world, dev, frames)
        b, touch_b = physics_states(world, dev, frames)
        c, touch_c = physics_states(world, cpu, frames)
        torch.cuda.synchronize()
        same = bool(torch.equal(a, b)) and touch_a == touch_b
        d_cpu = float((a.cpu() - c).abs().max())
        print(f"phase PH: {world}, {frames} frames, float32: two runs on "
              f"the card equal bit for bit: {same}; max |d| against the "
              f"CPU run {d_cpu} (tolerance {PHYSICS_TOL}); frames with a "
              f"touching pair {touch_a} (card) {touch_c} (CPU); final t "
              f"{float(a[-1, -1])}")
        assert same, world
        assert d_cpu <= PHYSICS_TOL, (world, d_cpu)
        assert bool(torch.isfinite(a).all()), world
        ph[world] = touch_a
        if world == "demo":
            drop = a
            ckpt_end(1, cli_run)
            cli_run = ckpt_start(2)
    ckpt_end(2, cli_run)
    assert ph["head-on"] > 0, ph  # GJK's contact path ran

    # the physics step kernel: against the eager step on the card, frame by
    # frame, and against the benchmark's reference on the CPU
    from ttrt_torch.kernels import physics as kphysics

    print(f"phase PH: physics step kernel launch (6 bodies) "
          f"{json.dumps(kphysics.physics_layout(6))}; ptxas: "
          f"{_ptxas_lines(build.build()[1], 'physics_step_kernel')}")
    st = physics_kernel_case(*physics_world("demo", dev), 120)
    print(f"phase PH: physics step kernel vs the eager step on the card, "
          f"demo drop: {json.dumps(st)}")
    assert st["first_mismatch"] is None, st
    st = physics_reference_case(dev, PHYSICS_REFERENCE_FRAMES)
    print(f"phase PH: physics step kernel vs benchmark/reference/physics.py "
          f"on the CPU, every leaf of every frame: {json.dumps(st)}")
    assert st["first_mismatch"] is None, st

    # every 30th frame of the drop (the states of the first run above)
    # rendered by the kernel and the plain version through the frame step
    # (no substep: the state as stepped)
    scene = demo_scene(assets.load_skybox("colors", device=dev), full.width,
                       full.height, dtype=torch.float32, device=dev)
    state0, params = demo.build_physics_demo(scene)
    offset = torch.zeros(3, device=dev)
    ph_err = 0.0
    for i in range(0, 121, 30):
        state = state0 if i == 0 else physics_state_of(drop[i - 1])
        stats = physics_frame_case(scene, full, params, state, offset)
        ph_err = max(ph_err, stats["max_abs"])
        print(f"phase PH: physics frame {i} (t={float(state.t):.4f}): "
              f"render kernel vs plain {json.dumps(stats)}")

    # the step's cost: host clock around a synchronized step, median, through
    # the kernel (physics_step's route here) and the eager step
    dt = torch.tensor(full.frame_duration, device=dev)
    step_host_ms = {}
    for name, fn in (("kernel", pworld.physics_step),
                     ("eager", pworld.physics_step_plain)):
        s, times = state0, []
        for _ in range(30):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s = fn(s, params, dt, demo.SUBSTEPS)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        step_host_ms[name] = statistics.median(times)
        with _OpCount() as ops:
            fn(state0, params, dt, demo.SUBSTEPS)
        kernels_a_frame = _cuda_kernels(
            lambda: fn(state0, params, dt, demo.SUBSTEPS))
        print(f"phase PH [{card}]: physics step through the {name}, one "
              f"frame of {demo.SUBSTEPS} substeps, 6 spheres (15 pairs): "
              f"{step_host_ms[name]:.4f} ms (host clock around a "
              f"synchronized step, median of 30; {ops.n} ATen ops, "
              f"{kernels_a_frame if kernels_a_frame else 'not measured'} "
              f"CUDA kernels by torch.profiler, copies and fills left out)")
    step_ms, how = _kernel_ms(
        lambda: pworld.physics_step(state0, params, dt, demo.SUBSTEPS),
        "physics_step_kernel")
    print(f"phase PH [{card}]: physics_step_kernel, one frame: {step_ms:.4f} "
          f"ms ({how})")

    # the main path in this process: run_physics, counts 0 before. The
    # frame rate is the physics' time step too, so the pace stays at 60 fps
    # (the frames take longer: pace waits for nothing)
    sink = io.BytesIO()
    timers = StageTimers()
    for fn in counters:
        fn.launches = 0
    kphysics.physics_step_cuda.launches = 0
    t0 = time.perf_counter()
    app.run_physics(full, "colors", N_FRAMES, interactive=False,
                    encode="device", device=dev, stream=sink, timers=timers)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ph_launches = [fn.launches for fn in counters]
    validate_stream(sink.getvalue(), full.width, full.height, N_FRAMES)
    assert ph_launches == [N_FRAMES, 0, 0, 0], ph_launches
    steps = PHYSICS_STEPS
    assert (steps.kernel, steps.eager) == (N_FRAMES, 0), vars(steps)
    ph_steps = kphysics.physics_step_cuda.launches
    assert ph_steps == N_FRAMES, ph_steps
    summary = timers.summary()
    split = {k: [round(st["mean_ms"], 4), round(st["p50_ms"], 4)]
             for k, st in summary.items()}
    print(f"phase PH [{card}]: run_physics, {N_FRAMES} frames in "
          f"{wall:.3f} s = {N_FRAMES / wall:.2f} fps end to end, stage "
          f"[mean, median] (ms; physics is within render+copy) "
          f"{json.dumps(split)}: render+copy without the physics "
          f"{summary['render+copy']['mean_ms'] - summary['physics']['mean_ms']:.4f}"
          f" ms; launches render {ph_launches[:2]} (kernel, plain)")

    # the physics frame's render: time and bound at frame 120's state
    s = state
    frame_scene = scene._replace(spheres=scene.spheres._replace(
        center=s.pos)).with_camera_frame(demo.physics_camera(s, full,
                                                             offset))
    _, ph_rays = render.render_frame_cuda(frame_scene, full)
    ph_ms = _median_ms(lambda: render.render_frame_cuda(
        frame_scene, full, count_rays=False))
    ph_plain_ms = _median_ms(lambda: render.render_frame_plain(
        frame_scene, full, count_rays=False), reps=5, warmup=1)
    ph_bound = demo_bound(int(ph_rays), n_px)
    print(f"phase PH [{card}]: physics frame 120's render: wrapper "
          f"{ph_ms:.4f} ms, plain version {ph_plain_ms:.3f} ms, "
          f"{int(ph_rays)} traces; bound {ph_bound[0]:.4f} ms by "
          f"{ph_bound[1]}; PH {time.perf_counter() - t_ph:.1f} s")

    # -- phase BT: the banded still ------------------------------------------
    t_bt = time.perf_counter()
    s = at(scene, 1.5)
    eager = {}
    for name, fn in (("whole", lambda: integrator.render_frame(
            s, full, count_rays=True)),
                     ("4 bands", lambda: integrator.render_frame_tiled(
                         s, full, 4, count_rays=True))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        fb, rays = fn()
        torch.cuda.synchronize()
        eager[name] = (fb.to_array().cpu().numpy(), int(rays),
                       1e3 * (time.perf_counter() - t0),
                       torch.cuda.max_memory_allocated())
    (ref, rays_ref, whole_ms, whole_mem), (til, rays_t, bands_ms, bands_mem) = (
        eager["whole"], eager["4 bands"])
    diff = np.abs(ref - til).max(axis=-1)
    bt = {"frac_off_1e-3": float((diff > 1e-3).mean()),
          "median_abs": float(np.median(diff)), "max_abs": float(diff.max()),
          "rays": rays_t, "rays_ref": rays_ref}
    assert bt["frac_off_1e-3"] <= 0.03 and bt["median_abs"] <= 2e-6, bt
    assert abs(rays_ref - rays_t) <= max(0.01 * rays_ref, 32), bt
    still = os.path.join(tmp.name, "bands.ppm")
    app.render_still(full, "colors", 1.5, still, device=dev,
                     renderer="eager", n_bands=4)
    img = assets.read_ppm(still)
    want = encode_rgb_frame(integrator.render_frame_tiled(
        s, full, 4)[0]).cpu().numpy()
    assert np.array_equal(img, want)
    print(f"phase BT [{card}]: render_still --bands 4 --renderer eager, "
          f"480x280x10x10: 4 bands vs the whole eager frame "
          f"{json.dumps(bt)}; the still's file equals the banded frame; "
          f"whole {whole_ms:.1f} ms, peak {whole_mem} bytes; bands "
          f"{bands_ms:.1f} ms, peak {bands_mem} bytes (one run each); "
          f"{time.perf_counter() - t_bt:.1f} s")
    tmp.cleanup()
    print(f"phases SF, PH, BT: {time.perf_counter() - t_start:.1f} s")

    def entry(**kw) -> dict:
        # no single PyTorch call renders a frame
        return {"route": "cuda", "library_ms": None, **kw}

    return [
        entry(name="render_scene_file",
              source="ttrt_torch/kernels/csrc/render.cu",
              replaces="ttrt/kernels/render_pallas.py:894",
              launches=launches["file"][0], max_abs_err=sf_err["uv_checker"],
              ms=sf_ms["uv_checker"], plain_ms=sf_plain_ms["uv_checker"],
              bound_ms=sf_bound["uv_checker"][0],
              bound_by=sf_bound["uv_checker"][1]),
        entry(name="render_image_sky_scene_file",
              source="ttrt_torch/kernels/csrc/render.cu",
              replaces="ttrt/kernels/render_pallas.py:989",
              launches=launches["file milky_way"][0],
              max_abs_err=sf_err["milky_way"], ms=sf_ms["milky_way"],
              plain_ms=sf_plain_ms["milky_way"],
              bound_ms=sf_bound["milky_way"][0],
              bound_by=sf_bound["milky_way"][1]),
        entry(name="pathtrace_scene_file",
              source="ttrt_torch/kernels/csrc/pathtrace.cu",
              replaces="ttrt/kernels/pathtrace_pallas.py:101",
              launches=launches["file pathtrace"][2],
              max_abs_err=sf_err["pathtrace"], ms=sf_ms["pathtrace"],
              plain_ms=sf_plain_ms["pathtrace"],
              bound_ms=sf_bound["pathtrace"][0],
              bound_by=sf_bound["pathtrace"][1]),
        entry(name="render_physics",
              source="ttrt_torch/kernels/csrc/render.cu",
              replaces="ttrt/kernels/render_pallas.py:894",
              launches=ph_launches[0], max_abs_err=ph_err, ms=ph_ms,
              plain_ms=ph_plain_ms, bound_ms=ph_bound[0],
              bound_by=ph_bound[1]),
        # no TPU kernel (JAX jits the step); its bound is its one launch
        entry(name="physics_step",
              source="ttrt_torch/kernels/csrc/physics.cu",
              replaces=None, launches=ph_steps, max_abs_err=0.0,
              ms=step_ms, plain_ms=step_host_ms["eager"], bound_ms=None,
              bound_by="launch"),
    ]


if __name__ == "__main__":
    sys.exit(main())
