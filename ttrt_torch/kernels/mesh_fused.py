"""The fused whole-frame kernel of the many-object tier: the CUDA wrapper
and its plain PyTorch version (port of ``ttrt/kernels/mesh_fused.py``).

One launch renders a band of rows x AA samples of a ``MeshScene`` frame:
primary rays, every bounce, the shadow ray of every light, the shading
from the materials in the cluster pack, and the sky (a procedural pattern
or an image cubemap, nearest or bilinear).
``render_band_mesh_fused`` dispatches on the device of the scene: CPU
tensors go through ``render_band_mesh_fused_plain``, CUDA tensors through
``render_band_mesh_fused_cuda``, which launches ``csrc/mesh.cu`` or raises.

The arithmetic is the JAX kernel's (``_fused_kernel``, mesh_fused.py:194):
the narrow tests are the expanded sphere quadratic with the pack's
ccr2 = |C|^2 - r^2 (:651-658) and Moller-Trumbore (:682-728), as written;
the shadows are the sqrt-free any-hit tests with the point-light cutoff
(:743-768, :787); the hit fixups, the reflected ray and the shading are
the demo kernel's (``kernels/render.py``), whose fused multiply-adds follow
the JAX oracle's compiled loop. The plain version tests every object; the
kernel culls with the quarter AABBs in a per-frame near-to-far order. Both
keep the lowest object id on an exact float tie (the JAX kernel keeps the
first-visited object, mesh_fused.py:96-107), so the culled kernel equals
the exhaustive plain version whatever it visits first.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ttrt_torch.config import ConfigError, RenderConfig
from ttrt_torch.kernels.render import (_bounce_chain, _F32_EPSILON,
                                       _finish_frame, _fma, _gen_primary_rays,
                                       _normalize3, _TraceOut, _tuples,
                                       DLIGHT_FLOATS, PLIGHT_FLOATS,
                                       check_sky, pack_camera, pack_dlights,
                                       pack_plights, sky_kind, sky_table)
from ttrt_torch.mesh.clusters import pack_rows
from ttrt_torch.mesh.dense import (_tri_t, chunks, nearest_arrays,
                                   sphere_blocks)
from ttrt_torch.vec import Vec3


def check_supported(scene, cfg: RenderConfig) -> None:
    """The gates of ``render_band_mesh_fused`` (mesh_fused.py:1431-1443)
    that this port keeps: float32, bounce_limit <= 16 (the per-ray trace
    counts pack 5-bit fields), a cluster pack, and a sky the kernels take
    (``render.check_sky``: a procedural pattern or an image cubemap of any
    size, nearest or bilinear)."""
    if cfg.dtype != torch.float32:
        raise ConfigError("the fused mesh kernel is float32-only")
    if cfg.bounce_limit > 16:
        raise ConfigError("the fused mesh kernel supports bounce_limit <= 16")
    if getattr(scene, "clusters", None) is None:
        raise ConfigError("the fused mesh kernel needs a MeshScene with a "
                          "cluster pack")
    check_sky(scene)


def order_subclusters(pack, origin: torch.Tensor) -> torch.Tensor:
    """(K,) int32 visit order over all subclusters (spheres' 0..kb_sph-1,
    then the triangles'), near to far by the squared distance from
    ``origin`` to the AABB center; invalid subclusters last
    (mesh_fused.py:96). The order only makes the best-t cull converge
    fast: the output does not depend on it."""
    lo = torch.cat([pack.sph_lo, pack.tri_lo], dim=0)
    hi = torch.cat([pack.sph_hi, pack.tri_hi], dim=0)
    valid = torch.cat([pack.sph_valid, pack.tri_valid]) != 0
    c = 0.5 * (lo + hi)
    d2 = ((c - origin[None, :].to(torch.float32)) ** 2).sum(dim=-1)
    key = torch.where(valid, d2, torch.inf)
    return torch.argsort(key, stable=True).to(torch.int32)


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------


def _shadow_blocked(sph, tri, px, py, pz, lx, ly, lz, tmax):
    """Any-hit shadow test from hit points p along unit directions l
    (mesh_fused.py:734-833), every object: spheres by the sqrt-free
    expanded quadratic (a == 1), triangles by Moller-Trumbore, with the
    point-light cutoff t < tmax when ``tmax`` is not None."""
    R = px.shape[0]
    out = torch.zeros(R, dtype=torch.bool, device=px.device)
    per_ray = lambda v, sl: v[sl][None] if v.dim() else v  # noqa: E731
    ray_chunk, sphere_chunk, tri_chunk = chunks(px.device)
    for r0 in range(0, R, ray_chunk):
        sl = slice(r0, r0 + ray_chunk)
        hx, hy, hz = px[sl][None], py[sl][None], pz[sl][None]
        ldx, ldy, ldz = (per_ray(v, sl) for v in (lx, ly, lz))
        tm = None if tmax is None else tmax[sl][None]
        soo = hx * hx + hy * hy + hz * hz
        od = hx * ldx + hy * ldy + hz * ldz
        blocked = out[sl]
        for s0 in range(0, sph.shape[0], sphere_chunk):
            hit = sphere_blocks(*(sph[s0:s0 + sphere_chunk, i, None]
                                  for i in range(4)),
                                hx, hy, hz, ldx, ldy, ldz, soo, od, tm)
            blocked = blocked | hit.any(dim=0)
        for s0 in range(0, tri.shape[0], tri_chunk):
            t, hit = _tri_t(*(tri[s0:s0 + tri_chunk, i, None]
                              for i in range(9)), hx, hy, hz, ldx, ldy, ldz)
            if tm is not None:
                hit = hit & (t < tm)
            blocked = blocked | hit.any(dim=0)
        out[sl] = blocked
    return out


def render_band_mesh_fused_plain(
    scene, cfg: RenderConfig, row_offset: float = 0.0,
    n_rows: Optional[int] = None, *, sample_offset: float = 0.0,
    n_samples: Optional[int] = None, reduce: str = "avg",
) -> Tuple[Vec3, torch.Tensor]:
    """The kernel's arithmetic in plain PyTorch over every object: returns
    the (n_rows, W) framebuffer of rows ``row_offset..`` and samples
    ``sample_offset..`` and its trace count (bounces + hits x n_lights).
    ``reduce='avg'`` scales the sample sum by 1/N, ``'sum'`` leaves it."""
    check_supported(scene, cfg)
    render_band_mesh_fused_plain.launches += 1
    n_rows = cfg.height if n_rows is None else n_rows
    n_samples = cfg.rays_per_pixel if n_samples is None else n_samples
    sph, tri = pack_rows(scene.clusters)
    n_sph = sph.shape[0]
    cam = pack_camera(scene.camera, torch.float32, row_offset, sample_offset)
    dl_vals = _tuples(pack_dlights(scene.directional_lights, torch.float32),
                      DLIGHT_FLOATS)
    pl_vals = _tuples(pack_plights(scene.point_lights, torch.float32),
                      PLIGHT_FLOATS)

    def trace(ox, oy, oz, dx, dy, dz):
        gh = nearest_arrays(sph[:, :4], tri[:, :9], n_sph,
                            Vec3(ox, oy, oz), Vec3(dx, dy, dz))
        hit = gh.obj >= 0
        is_tri = gh.obj >= n_sph
        t = torch.where(hit, gh.t, 0.0)
        px, py, pz = _fma(t, dx, ox), _fma(t, dy, oy), _fma(t, dz, oz)
        s = sph[torch.clamp(gh.obj, 0, max(n_sph - 1, 0)).long()]
        tr = tri[torch.clamp(gh.obj - n_sph, 0,
                             max(tri.shape[0] - 1, 0)).long()]
        pick = lambda i, j: torch.where(is_tri, tr[:, j], s[:, i])  # noqa: E731
        nrx = torch.where(is_tri, tr[:, 9], px - s[:, 0])
        nry = torch.where(is_tri, tr[:, 10], py - s[:, 1])
        nrz = torch.where(is_tri, tr[:, 11], pz - s[:, 2])
        tox, toy, toz = _normalize3(ox - px, oy - py, oz - pz)
        eps = _F32_EPSILON
        nx, ny, nz = _normalize3(torch.where(hit, nrx, dx),
                                 torch.where(hit, nry, dy),
                                 torch.where(hit, nrz, dz))
        return _TraceOut(
            hit,
            torch.where(hit, _fma(tox, eps, px), ox),
            torch.where(hit, _fma(toy, eps, py), oy),
            torch.where(hit, _fma(toz, eps, pz), oz),
            nx, ny, nz, pick(4, 12), pick(5, 13), pick(6, 14),
            torch.where(hit, pick(7, 15), 0.0), pick(8, 16))

    def shadow_test(px, py, pz):
        return lambda lx, ly, lz, tmax: _shadow_blocked(
            sph, tri, px, py, pz, lx, ly, lz, tmax)

    ox, oy, oz, dx, dy, dz = _gen_primary_rays(cam, cfg, n_rows, n_samples)
    chain = _bounce_chain(
        ox, oy, oz, dx, dy, dz, trace, shadow_test, dl_vals, pl_vals,
        cfg.bounce_limit, cfg.specular, cfg.energy_model == "subtract")
    scale = 1.0 / cfg.rays_per_pixel if reduce == "avg" else 1.0
    return _finish_frame(*chain, scene, cfg, n_rows, n_samples, scale,
                         len(dl_vals) + len(pl_vals))


render_band_mesh_fused_plain.launches = 0


def render_frame_mesh_fused_plain(scene, cfg: RenderConfig
                                  ) -> Tuple[Vec3, torch.Tensor]:
    """The whole frame through the plain version."""
    return render_band_mesh_fused_plain(scene, cfg)


# ---------------------------------------------------------------------------
# The CUDA kernel's wrapper
# ---------------------------------------------------------------------------


def render_band_mesh_fused_cuda(
    scene, cfg: RenderConfig, row_offset: float = 0.0,
    n_rows: Optional[int] = None, *, sample_offset: float = 0.0,
    n_samples: Optional[int] = None, reduce: str = "avg",
) -> Tuple[Vec3, torch.Tensor]:
    """Render a band with the CUDA kernel (csrc/mesh.cu,
    ``ttrt_mesh_fused``): one thread per (pixel, sample), a pixel's
    samples in one block and added there in sample order, the bounces as
    a loop, the quarter boxes staged in shared memory in the frame's visit
    order (read in place past what a block holds); writes the
    (3, n_rows, W) sample average (or sum) and the per-pixel trace counts
    (``fused_layout`` gives the launch shape). The wrapper computes the
    per-frame visit order (an argsort over the K subclusters) and packs
    the camera and lights. Raises on anything the kernel does not take,
    CPU tensors included."""
    from ttrt_torch.kernels import build

    check_supported(scene, cfg)
    n_rows = cfg.height if n_rows is None else n_rows
    n_samples = cfg.rays_per_pixel if n_samples is None else n_samples
    pack = scene.clusters
    dev = pack.sph.device
    if dev.type != "cuda" or scene.camera.frame.origin.device != dev:
        raise ValueError("render_band_mesh_fused_cuda needs the scene on a "
                         f"CUDA device, got {dev}")
    n_dl = scene.directional_lights.count
    n_pl = scene.point_lights.count
    tab = pack.tables
    order = order_subclusters(pack, scene.camera.frame.origin)
    cam = pack_camera(scene.camera, torch.float32, row_offset,
                      sample_offset).contiguous()
    dl = pack_dlights(scene.directional_lights, torch.float32).contiguous()
    pl = pack_plights(scene.point_lights, torch.float32).contiguous()
    texels = sky_table(scene.skybox, dev)
    W = cfg.width
    out = torch.empty((3, n_rows, W), dtype=torch.float32, device=dev)
    counts = torch.empty((n_rows, W), dtype=torch.int32, device=dev)
    lib = build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    scale = 1.0 / cfg.rays_per_pixel if reduce == "avg" else 1.0
    rc = lib.ttrt_mesh_fused(
        cam.data_ptr(), dl.data_ptr(), n_dl, pl.data_ptr(), n_pl,
        tab.sph.data_ptr(), tab.sph_mat.data_ptr(), tab.sph_spec.data_ptr(),
        tab.sph_id.data_ptr(), tab.tri.data_ptr(), tab.tri_nrm.data_ptr(),
        tab.tri_mat.data_ptr(), tab.tri_spec.data_ptr(),
        tab.tri_id.data_ptr(), tab.qbox.data_ptr(), order.data_ptr(),
        tab.kb_sph, tab.kb_tri, W, cfg.height, cfg.rays_per_pixel, n_rows,
        n_samples, cfg.bounce_limit, int(cfg.specular),
        int(cfg.energy_model == "subtract"),
        sky_kind(scene.skybox), scene.skybox.dim, int(cfg.skybox_bilinear),
        texels.data_ptr(), scale, out.data_ptr(), counts.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"fused mesh kernel launch failed: CUDA error {rc}")
    render_band_mesh_fused_cuda.launches += 1
    return Vec3(out[0], out[1], out[2]), counts.sum(dtype=torch.int64)


render_band_mesh_fused_cuda.launches = 0


LAYOUT_KEYS = ("sample_threads", "pixels_per_block",
               "threads_per_block", "blocks", "smem_bytes", "boxes_staged",
               "lights_staged", "blocks_per_sm", "sms", "registers",
               "local_bytes")


def fused_layout(scene, cfg: RenderConfig, n_rows: Optional[int] = None,
                 n_samples: Optional[int] = None) -> dict:
    """The launch shape ``render_band_mesh_fused_cuda`` takes for a band of
    ``scene`` (``ttrt_mesh_fused_layout``): the sample threads of a pixel,
    pixels, threads and dynamic shared bytes of a block, the blocks,
    whether the boxes and the lights are staged in shared memory, the
    blocks an SM holds and the SMs (hence ``waves``), and the kernel's
    registers and local (spill) bytes a thread. Needs a CUDA device."""
    from ttrt_torch.kernels import build

    tab = scene.clusters.tables
    return build.layout(
        "ttrt_mesh_fused_layout", LAYOUT_KEYS, tab.kb_sph, tab.kb_tri,
        scene.directional_lights.count, scene.point_lights.count, cfg.width,
        cfg.height if n_rows is None else n_rows,
        cfg.rays_per_pixel if n_samples is None else n_samples)


def render_band_mesh_fused(scene, cfg: RenderConfig, row_offset: float = 0.0,
                           n_rows: Optional[int] = None, **kw
                           ) -> Tuple[Vec3, torch.Tensor]:
    """A band of a MeshScene frame on the device that holds the scene: the
    plain version for CPU tensors, the CUDA kernel for CUDA tensors."""
    if scene.clusters is not None and scene.clusters.sph.device.type == "cpu":
        return render_band_mesh_fused_plain(scene, cfg, row_offset, n_rows,
                                            **kw)
    return render_band_mesh_fused_cuda(scene, cfg, row_offset, n_rows, **kw)


def render_frame_mesh_fused(scene, cfg: RenderConfig, *,
                            count_rays: bool = True
                            ) -> Tuple[Vec3, Optional[torch.Tensor]]:
    """Whole-frame render of a MeshScene: the (H, W) framebuffer and the
    trace count (None when ``count_rays`` is False). Takes the place of the
    integrator's ``render_frame`` on scenes with a cluster pack."""
    fb, rays = render_band_mesh_fused(scene, cfg)
    return fb, rays if count_rays else None
