"""The invariants the path-tracing and sky-weight kernels' thread mappings
rest on, on the CPU.

The path-tracing kernel (``csrc/pathtrace.cu::pathtrace_kernel``) runs
each sample of a pixel on its own thread, S neighbouring threads of one
block a pixel (``common.cuh::sample_threads``: S from ``sample_rounds``,
all N samples in one round up to 32, else in rounds of at most 32). Each
thread traces one path with the JAX kernel's ray index k * (W*H) + pixel;
the pixel's first thread adds the paths' colors in sample order from
+0.0, the sum waiting in shared memory between rounds, then writes the
sum or the sum divided by N and clipped, and the sums of the per-path
counts. Its plain version (``pathtrace_frame_plain``) reduces the
sample-major per-ray colors of ``_paths`` in one pass. So the frame has
to be the in-order per-pixel sum of those colors, bit for bit, in both
reduce modes; the mapping has to visit every (pixel, sample) once for
every block the launch can choose; the mean has to be a division (a
product with 1/N rounds differently); and the packed counts have to add
without carrying. The sky-weight kernel (``render.cu::sky_weight_kernel``)
runs one thread per ray, a pixel's samples on neighbouring threads, and
writes each ray's weight where the JAX rays' sample-major lanes have it.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import chip_smoke
from make_torch_golden import (jax_area_lights, jax_frame_seed, jax_scene,
                               scene_leaves)
from ttrt.assets import make_colors_skybox, make_uv_checker_skybox
from ttrt.config import RenderConfig as JaxRenderConfig
from ttrt.kernels import pathtrace_pallas as jpt
from ttrt.kernels import render_pallas

from ttrt_torch.config import RenderConfig
from ttrt_torch.kernels import pathtrace, render
from ttrt_torch.render.pathtrace import AreaLights
from ttrt_torch.scene import scene_from_numpy

torch.set_num_threads(1)  # the test workers share the cores

W, H, SPP, BOUNCES = 24, 12, 4, 6
SKIES = {"colors": make_colors_skybox, "uv_checker": make_uv_checker_skybox}
MAX_ROUND = 32  # common.cuh
# pick_block's candidate blocks for the path tracer (PT_BLOCK,
# PT_MAX_THREADS)
BLOCKS = (256, 512)


def _pair(t=0.7, w=W, h=H, sky="colors"):
    """The JAX demo scene and area light, and the port's made from their
    leaves."""
    js = jax_scene(t, w, h, SKIES[sky], 16, sky)
    jl = jax_area_lights()
    ts = scene_from_numpy(scene_leaves(js), sky, device="cpu",
                          dtype=torch.float32)
    tl = AreaLights.from_numpy(scene_leaves(jl), dtype=torch.float32,
                               device="cpu")
    return js, jl, ts, tl


def sample_rounds(n: int):
    """common.cuh::sample_rounds: S sample threads a pixel, and whether a
    pixel's samples take more than one round."""
    rounds = -(-n // MAX_ROUND)
    return -(-n // rounds), rounds > 1


def sample_threads(color: np.ndarray, n_pixels: int, block: int):
    """common.cuh::sample_threads on the host: ``color`` holds each ray's
    float32 value, sample-major (N * n_pixels,). Blocks of P = block // S
    pixels, thread s of pixel p taking sample k0 + s of each round k0;
    the pixel's first thread adds a round's values in sample order onto
    the sum carried from the last round (from +0.0). Returns the
    per-pixel sums and how often each ray was taken."""
    n = color.size // n_pixels
    S, _ = sample_rounds(n)
    P = block // S
    visits = np.zeros(color.size, np.int64)
    sums = np.zeros(n_pixels, np.float32)
    for blk in range(-(-n_pixels // P)):
        acc = np.zeros(P, np.float32)
        for k0 in range(0, n, S):
            col = np.zeros(P * S, np.float32)  # the round's shared colors
            for tid in range(P * S):
                p, s = divmod(tid, S)
                pix, k = blk * P + p, k0 + s
                if pix < n_pixels and k < n:
                    visits[k * n_pixels + pix] += 1
                    col[tid] = color[k * n_pixels + pix]
            for p in range(P):
                r = acc[p] if k0 > 0 else np.float32(0.0)
                for j in range(min(S, n - k0)):
                    r = np.float32(r + col[p * S + j])
                acc[p] = r
        live = min(P, n_pixels - blk * P)
        sums[blk * P:blk * P + live] = acc[:live]
    return sums, visits


def _in_order(color: torch.Tensor, n: int) -> torch.Tensor:
    """The kernel's per-pixel sum of sample-major ray values: in sample
    order, from +0.0."""
    c = color.reshape(n, -1)
    acc = torch.zeros_like(c[0])
    for k in range(n):
        acc = acc + c[k]
    return acc


@pytest.mark.parametrize("sky,bilinear", [("colors", False),
                                          ("uv_checker", False),
                                          ("uv_checker", True)])
def test_per_ray_colors_summed_in_order_are_the_frame(sky, bilinear):
    """The per-ray colors of ``_paths`` added per pixel in sample order
    from +0.0 are the plain version's sum, and divided by N (then
    clipped) its mean, bit for bit; the frame's work is ``_paths``'."""
    _, _, ts, tl = _pair(sky=sky)
    cfg = RenderConfig(width=W, height=H, rays_per_pixel=SPP,
                       bounce_limit=BOUNCES, skybox_bilinear=bilinear)
    seed = pathtrace.frame_seed(0, 0.7)
    color, work = pathtrace._paths(ts, tl, cfg, seed)
    acc = [_in_order(c, SPP).reshape(H, W) for c in color]
    fb, work_sum = pathtrace.pathtrace_frame_plain(ts, tl, cfg, seed,
                                                   reduce="sum")
    for a, c in zip(acc, fb):
        assert torch.equal(a, c)
    fb, work_mean = pathtrace.pathtrace_frame_plain(ts, tl, cfg, seed)
    n = torch.tensor(SPP, dtype=torch.float32)
    for a, c in zip(acc, fb):
        assert torch.equal(torch.clamp(a / n, 0.0, 1.0), c)
    assert torch.equal(work_sum, work) and torch.equal(work_mean, work)
    assert float(max(a.max() for a in acc)) > 1.0  # the sum is unclipped


@pytest.mark.parametrize("n", [4, 10, 33])
def test_sample_thread_mapping_takes_every_sample_once(n):
    """For every block pick_block can choose, on a frame whose pixel count
    is no multiple of its pixels (P): each (pixel, sample) is taken once,
    and the per-pixel sums, rounds and all, are the in-order sums."""
    w, h = 23, 9
    S, rounds = sample_rounds(n)
    assert rounds == (n > MAX_ROUND) and S <= MAX_ROUND
    color = np.random.default_rng(n).random(n * w * h, np.float32) * 4
    want = _in_order(torch.from_numpy(color), n).numpy()
    for block in BLOCKS:
        assert (w * h) % (block // S) != 0
        sums, visits = sample_threads(color, w * h, block)
        assert (visits == 1).all(), block
        np.testing.assert_array_equal(sums, want)


def test_two_rounds_of_sample_threads_give_the_frame():
    """33 samples: rounds of 17 and 16 sample threads; the mapping over
    ``_paths``' colors gives the plain version's frame bit for bit."""
    w, h, n = 13, 5, 33
    assert sample_rounds(n) == (17, True)
    _, _, ts, tl = _pair(w=w, h=h)
    cfg = RenderConfig(width=w, height=h, rays_per_pixel=n, bounce_limit=4)
    seed = pathtrace.frame_seed(0, 3.3)
    color, _ = pathtrace._paths(ts, tl, cfg, seed)
    fb, _ = pathtrace.pathtrace_frame_plain(ts, tl, cfg, seed, reduce="sum")
    for c, want in zip(color, fb):
        sums, visits = sample_threads(c.numpy(), w * h, BLOCKS[0])
        assert (visits == 1).all()
        np.testing.assert_array_equal(sums.reshape(h, w), want.numpy())


def test_mean_is_a_division_not_a_product_with_its_inverse():
    """At 10 samples, sum * float32(1/10) differs from sum / 10 on some
    pixels, and the plain version's mean is the division: the kernel's
    mean cannot go through the render kernel's ``scale``."""
    n = 10
    _, _, ts, tl = _pair()
    cfg = RenderConfig(width=W, height=H, rays_per_pixel=n,
                       bounce_limit=BOUNCES)
    seed = pathtrace.frame_seed(0, 0.7)
    color, _ = pathtrace._paths(ts, tl, cfg, seed)
    fb, _ = pathtrace.pathtrace_frame_plain(ts, tl, cfg, seed)
    sums = torch.stack([_in_order(c, n) for c in color]).numpy()
    div = sums / np.float32(n)
    mul = sums * np.float32(1.0 / n)
    assert div.dtype == mul.dtype == np.float32
    assert (div != mul).sum() > 0
    want = np.clip(div, 0.0, 1.0).reshape(3, H, W)
    for c, m in zip(fb, want):
        np.testing.assert_array_equal(c.numpy(), m)


def test_packed_counts_add_without_carrying():
    """A path's nearest-hit traces (at most bounce_limit) | hits << 16,
    added over a pixel's samples, is the pixel's nearest | hits << 16 for
    any counts the gate N * bounce_limit <= 0x7FFF lets through, at its
    extremes; the unblocked shadow rays are a channel of their own, since
    their worst case (N * bounce_limit * MAX_AREA_LIGHTS) passes 16 bits."""
    rng = np.random.default_rng(5)
    for bounces in (1, 6, 10):
        n = pathtrace.MAX_PIXEL_TRACES // bounces
        nearest = rng.integers(1, bounces + 1, (64, n))
        nearest[0] = bounces  # every path at the bounce limit
        hits = nearest - rng.integers(0, 2, (64, n))
        hits[0] = nearest[0]
        packed = (nearest | hits << 16).sum(axis=1)
        assert (packed & 0xFFFF == nearest.sum(axis=1)).all()
        assert (packed >> 16 == hits.sum(axis=1)).all()
        assert packed.max() < 1 << 31  # an int32 of the output
    worst = pathtrace.MAX_PIXEL_TRACES * pathtrace.MAX_AREA_LIGHTS
    assert worst > 0xFFFF and worst < 1 << 31


def test_reassembled_frame_meets_pallas_interpret():
    """16x8, 3 spp, 3 bounces: ``_paths``' colors through the mapping
    (blocks of 85 pixels of 3 threads, two of them, the last ragged),
    divided by N and clipped, against JAX's kernel on the same scene,
    light and frame seed, through PATHTRACE_BAR."""
    w, h, n, b = 16, 8, 3, 3
    js, jl, ts, tl = _pair(w=w, h=h)
    seed = jax_frame_seed(0, 0.7)
    jcfg = JaxRenderConfig(width=w, height=h, rays_per_pixel=n,
                           bounce_limit=b, dtype=jnp.float32)
    ref = np.asarray(jpt.pathtrace_frame_pallas(
        js, jl, jcfg, seed, interpret=True).to_array())
    cfg = RenderConfig(width=w, height=h, rays_per_pixel=n, bounce_limit=b)
    color, _ = pathtrace._paths(ts, tl, cfg, seed)
    out = np.stack([np.clip(sample_threads(c.numpy(), w * h, BLOCKS[0])[0]
                            / np.float32(n), 0.0, 1.0).reshape(h, w)
                    for c in color], -1)
    stats = chip_smoke.pathtrace_bar(ref, out)
    assert stats["differ_px"] == 0, stats


def test_sky_weight_threads_fill_the_jax_lanes():
    """Thread i of the sky-weight kernel takes ray (k, pixel) = (i % N,
    i // N), a pixel's samples on neighbouring threads, and writes
    out_w[k * (W*H) + pixel]: over a grid of 128-thread blocks (the last
    ragged), every lane of JAX's ``_sky_weight_kernel`` (interpret mode,
    its rays sample-major) is written once, with the plain version's
    weight, which equals JAX's lane by lane."""
    w, h, n = 16, 8, 3
    js = jax_scene(0.7, w, h)
    ts = scene_from_numpy(scene_leaves(js), "colors", device="cpu",
                          dtype=torch.float32)
    jcfg = JaxRenderConfig(width=w, height=h, rays_per_pixel=n,
                           bounce_limit=3, dtype=jnp.float32)
    cfg = RenderConfig(width=w, height=h, rays_per_pixel=n, bounce_limit=3)
    packed = render_pallas.pack_scene(js, jnp.float32)
    n_rays = w * h * n
    tile = render_pallas.TILE_R * render_pallas.LANES
    n_tiles = pl.cdiv(n_rays, tile)
    smem = pl.BlockSpec(memory_space=pltpu.SMEM)
    lanes = np.asarray(pl.pallas_call(
        functools.partial(
            render_pallas._sky_weight_kernel, cfg=jcfg,
            n_spheres=js.spheres.count, n_dl=js.directional_lights.count,
            n_pl=js.point_lights.count, tile_r=render_pallas.TILE_R,
            n_rows=h, n_samples=n),
        grid=(n_tiles,),
        out_shape=jax.ShapeDtypeStruct(
            (n_tiles, render_pallas.TILE_R, render_pallas.LANES),
            jnp.float32),
        in_specs=[smem] * 5,
        out_specs=pl.BlockSpec(
            (1, render_pallas.TILE_R, render_pallas.LANES),
            lambda i: (i, 0, 0), memory_space=pltpu.VMEM),
        interpret=True,
    )(packed.cam, packed.spheres, packed.plane, packed.dlights,
      packed.plights)).reshape(-1)[:n_rays]
    plain = render.sky_weights_plain(ts, cfg).numpy()
    out = np.full(n_rays, np.nan, np.float32)
    writes = np.zeros(n_rays, np.int64)
    n_px = w * h
    for i in range(-(-n_rays // 128) * 128):  # every thread of the grid
        if i >= n_rays:
            continue
        pix, k = divmod(i, n)
        out[k * n_px + pix] = plain[k, pix // w, pix % w]
        writes[k * n_px + pix] += 1
    assert (writes == 1).all()
    np.testing.assert_array_equal(out, lanes)
    assert float(lanes.max()) > 0.0
