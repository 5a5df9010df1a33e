"""Multi-device rendering: the pixel grid sharded over a device mesh (port
of ``ttrt/parallel/sharding.py``).

Rays are independent, so the frame shards with no communication while it
is traced. The ("rows", "samples") mesh gives each rank a band of image
rows (``rows``) and a slice of each pixel's AA samples (``samples``); the
scene is replicated. Each renderer is a per-rank **partial** (one kernel
launch, or the eager integrator, on the rank's band x slice, returning the
per-pixel sample SUM) and a **combine**, a pure function of the partials:
the sum over ``samples`` in order, times float32(1/N) of the frame's N,
and the bands stacked over ``rows`` (TerminalRayTracer.c:1061-1065, the
sum reassociated across devices). The path tracer's ranks each render the
whole image at spp/n_devices with their own random stream; its combine
sums every rank's unclipped radiance in mesh order, times 1/N, and clips
once. The one collective, ``parallel.mesh.gather``, only moves the
partials, so a frame's bits do not depend on the transport, and
``chip_smoke.py`` checks every decomposition on one card through the same
combine functions.

Every rank returns the whole frame, as JAX's replicated outputs.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ttrt_torch.config import ConfigError, RenderConfig
from ttrt_torch.kernels import mesh_fused, pathtrace, render
from ttrt_torch.kernels.render import Band
from ttrt_torch.parallel.mesh import OBJECTS, coordinate, flat_index, gather
from ttrt_torch.parallel.mesh import shape as mesh_shape
from ttrt_torch.render import integrator
from ttrt_torch.render import pathtrace as estimator
from ttrt_torch.term.encoder import encode_ansi_frame, encode_rgb_frame
from ttrt_torch.vec import Vec3, scalar_like

MASK32 = 0xFFFFFFFF


def _indivisible(cfg: RenderConfig, mesh: DeviceMesh) -> Optional[str]:
    """Why the frame does not split over the mesh's ray axes, or None."""
    n = mesh_shape(mesh)
    if cfg.height % n["rows"]:
        return f"height {cfg.height} not divisible by mesh rows {n['rows']}"
    if cfg.rays_per_pixel % n["samples"]:
        return (f"rays_per_pixel {cfg.rays_per_pixel} not divisible by mesh "
                f"samples {n['samples']}")
    return None


def check_mesh_divisible(cfg: RenderConfig, mesh: DeviceMesh) -> None:
    """CLI-facing divisibility check: ConfigError (a one-line CLI message)
    instead of the renderers' ValueError."""
    why = _indivisible(cfg, mesh)
    if why:
        raise ConfigError(why)


def _check_divisible(cfg: RenderConfig, mesh: DeviceMesh) -> None:
    why = _indivisible(cfg, mesh)
    if why:
        raise ValueError(why)


def band_at(cfg: RenderConfig, n_rows_axis: int, n_samples_axis: int,
            i: int, j: int, reduce: str = "sum") -> Band:
    """The band x slice of the device at (row i, sample j) of a
    ``n_rows_axis`` x ``n_samples_axis`` decomposition."""
    rows = cfg.height // n_rows_axis
    samples = cfg.rays_per_pixel // n_samples_axis
    return Band(i * rows, rows, j * samples, samples, reduce)


def band_of(cfg: RenderConfig, mesh: DeviceMesh) -> Band:
    """This rank's band x slice, its samples summed."""
    _check_divisible(cfg, mesh)
    n, at = mesh_shape(mesh), coordinate(mesh)
    return band_at(cfg, n["rows"], n["samples"], at["rows"], at["samples"])


def combine_bands(partials: Mapping[Tuple[int, int], Vec3],
                  cfg: RenderConfig) -> Vec3:
    """The (H, W) frame from the per-pixel sample sums of every (row i,
    sample j) band x slice: for each band the slices summed in order j =
    0, 1, ..., times float32(1/N) (JAX's ``psum(...) * (1.0 / N)``,
    sharding.py:413-415), the bands stacked in row order. With one slice a
    band this is the whole-frame kernel's arithmetic, bit for bit."""
    n_i = 1 + max(i for i, _ in partials)
    n_j = 1 + max(j for _, j in partials)
    bands = []
    for i in range(n_i):
        acc = partials[(i, 0)]
        for j in range(1, n_j):
            acc = acc + partials[(i, j)]
        bands.append(acc * scalar_like(1.0 / cfg.rays_per_pixel, acc.x))
    return Vec3(*(torch.cat([b[c] for b in bands]) for c in range(3)))


def combine_pathtrace(partials: Sequence[Vec3], cfg: RenderConfig) -> Vec3:
    """The path-traced frame from every device's unclipped radiance sums,
    in mesh order: summed, times float32(1/N) of the total sample count,
    clipped to [0, 1] once (sharding.py:262-266): the single-device
    estimator with the same sample count, not a mean of clipped means."""
    acc = partials[0]
    for p in partials[1:]:
        acc = acc + p
    inv_n = scalar_like(1.0 / cfg.rays_per_pixel, acc.x)
    return Vec3(*(torch.clamp(c * inv_n, 0.0, 1.0) for c in acc))


def _stacked(fb: Vec3) -> torch.Tensor:
    return torch.stack([fb.x, fb.y, fb.z])


def gather_bands(mesh: DeviceMesh, cfg: RenderConfig, fb: Vec3,
                           count: Optional[torch.Tensor]):
    """Gather every rank's band sums and combine them
    (``combine_bands``); ranks along the objects axis hold the same band,
    so only those at objects index 0 count. Returns (frame, trace count
    or None)."""
    parts = gather(mesh, _stacked(fb))
    bands = {(at[0], at[1]): Vec3(*p) for at, p in parts.items()
             if len(at) == 2 or at[2] == 0}
    frame = combine_bands(bands, cfg)
    if count is None:
        return frame, None
    total = count.to(torch.int64).reshape(1).clone()
    if coordinate(mesh).get(OBJECTS, 0):
        total.zero_()
    dist.all_reduce(total)
    return frame, total[0]


def sample_sums(color: Vec3, n_rows: int, width: int,
                 n_samples: int) -> Vec3:
    """Pixel-major per-ray colors -> the (n_rows, W) in-order sums of each
    pixel's samples."""
    def part(c):
        c = c.reshape(n_rows, width, n_samples)
        acc = c[..., 0]
        for k in range(1, n_samples):
            acc = acc + c[..., k]
        return acc
    return Vec3(*(part(c) for c in color))


def band_rays(scene, cfg: RenderConfig, band: Band):
    """The eager integrator's primary rays of a band x slice, pixel-major:
    ray (row, col, k) of the band's rows and samples."""
    o, d = integrator.generate_rays(scene, cfg, band.row_offset,
                                    band.n_rows)
    ks = slice(band.sample_offset, band.sample_offset + band.n_samples)

    def cut(c):
        return c.reshape(band.n_rows, cfg.width,
                         cfg.rays_per_pixel)[..., ks].reshape(-1)
    return Vec3(*(cut(c) for c in o)), Vec3(*(cut(c) for c in d))


def render_frame_sharded(scene, cfg: RenderConfig, mesh: DeviceMesh, *,
                         count_rays: bool = True):
    """Sharded ``integrator.render_frame``: each rank traces its band x
    slice with the eager integrator (float32 or float64, any scene type,
    the CPU included); the combine gives every rank the (H, W) frame and
    the total trace count."""
    band = band_of(cfg, mesh)
    o, d = band_rays(scene, cfg, band)
    color, rays = integrator.trace_batch(scene, o, d, cfg, count_rays=True)
    fb = sample_sums(color, band.n_rows, cfg.width, band.n_samples)
    return gather_bands(mesh, cfg, fb,
                                  rays if count_rays else None)


def render_frame_sharded_kernel(scene, cfg: RenderConfig, mesh: DeviceMesh,
                                *, count_rays: bool = True):
    """The demo kernel over the mesh (``render_frame_sharded_pallas``,
    sharding.py:373): one ``render_band`` launch a rank on its band x
    slice, samples summed, then the combine."""
    band = band_of(cfg, mesh)
    fb, count = render.render_band(
        scene, cfg, band.row_offset, band.n_rows,
        sample_offset=band.sample_offset, n_samples=band.n_samples,
        reduce="sum", count_rays=count_rays)
    return gather_bands(mesh, cfg, fb, count)


def render_frame_sharded_mesh_fused(scene, cfg: RenderConfig,
                                    mesh: DeviceMesh, *,
                                    count_rays: bool = True):
    """The fused many-object kernel over the mesh
    (``render_frame_sharded_mesh_fused``, sharding.py:315): one
    ``render_band_mesh_fused`` launch a rank, the cluster pack replicated,
    then the combine."""
    band = band_of(cfg, mesh)
    fb, count = mesh_fused.render_band_mesh_fused(
        scene, cfg, band.row_offset, band.n_rows,
        sample_offset=band.sample_offset, n_samples=band.n_samples,
        reduce="sum")
    return gather_bands(mesh, cfg, fb,
                                  count if count_rays else None)


def check_pathtrace_mesh(cfg: RenderConfig, mesh: DeviceMesh) -> None:
    """CLI-facing validation for ``--pathtrace --mesh``: the path tracer
    shards samples (no geometry axis) and needs an even spp split."""
    if OBJECTS in mesh.mesh_dim_names:
        raise ConfigError(
            "--pathtrace shards samples, not geometry: use a "
            "ROWSxSAMPLES --mesh (no objects factor)")
    n_dev = mesh.size()
    if cfg.rays_per_pixel % n_dev:
        raise ConfigError(
            f"--pathtrace --mesh: --spp {cfg.rays_per_pixel} not "
            f"divisible by {n_dev} devices")


def device_seed(seed: int, idx: int) -> int:
    """Device ``idx``'s stream of frame seed ``seed`` (sharding.py:
    252-257): mix32((idx + 1) * 0x9E3779B9 mod 2^32) ^ seed, as an
    int32."""
    h = pathtrace.mix32(((idx + 1) * pathtrace.GOLDEN) & MASK32) \
        ^ (seed & MASK32)
    return h - (1 << 32) if h >= 1 << 31 else h


def _local_cfg(cfg: RenderConfig, mesh: DeviceMesh) -> RenderConfig:
    n = mesh.size()
    if cfg.rays_per_pixel % n:
        raise ValueError(f"rays_per_pixel {cfg.rays_per_pixel} not "
                         f"divisible by {n} devices")
    return cfg.with_(rays_per_pixel=cfg.rays_per_pixel // n)


def _combine_pathtrace_partials(mesh: DeviceMesh, cfg: RenderConfig,
                                fb: Vec3) -> Vec3:
    parts = gather(mesh, _stacked(fb))
    return combine_pathtrace([Vec3(*parts[at]) for at in sorted(parts)],
                             cfg)


def pathtrace_frame_sharded_kernel(scene, lights, cfg: RenderConfig,
                                   seed: int, mesh: DeviceMesh) -> Vec3:
    """The path-tracing kernel over the mesh
    (``pathtrace_frame_sharded_pallas``, sharding.py:223): every rank
    renders the whole image at spp/n_devices in the kernel's sum mode,
    seeded with its ``device_seed``; the combine sums, divides and clips
    once."""
    fb, _ = pathtrace.pathtrace_frame(
        scene, lights, _local_cfg(cfg, mesh),
        device_seed(seed, flat_index(mesh)), count_rays=False, reduce="sum")
    return _combine_pathtrace_partials(mesh, cfg, fb)


def pathtrace_frame_sharded(scene, lights, cfg: RenderConfig, seed: int,
                            mesh: DeviceMesh) -> Vec3:
    """The eager estimator over the mesh (``pathtrace_frame_sharded``,
    sharding.py:272): as the kernel's sharded renderer, each rank drawing from its
    own ``torch.Generator`` seeded with its ``device_seed`` of ``seed``."""
    device = scene.spheres.radius.device
    gen = torch.Generator(device=device).manual_seed(
        device_seed(seed, flat_index(mesh)) & MASK32)
    fb = estimator.pathtrace_frame(scene, lights, _local_cfg(cfg, mesh), gen,
                                   reduce="sum")
    return _combine_pathtrace_partials(mesh, cfg, fb)


def make_sharded_frame_fn(scene, cfg: RenderConfig, mesh: DeviceMesh,
                          encode: str = "ansi"):
    """t -> (encoded frame, trace count) over the mesh through the eager
    integrator (``make_sharded_frame_fn``, sharding.py:185). ``encode``
    selects 'ansi' (the uint8 escape buffer) or 'rgb' ((H, W, 3) uint8)."""
    from ttrt_torch.frames import orbit_camera_frame

    enc = encode_ansi_frame if encode == "ansi" else encode_rgb_frame
    device = scene.spheres.radius.device

    def frame(t: float):
        s = scene.with_camera_frame(
            orbit_camera_frame(t, dtype=cfg.dtype, device=device))
        fb, rays = render_frame_sharded(s, cfg, mesh)
        return enc(fb), rays

    return frame
