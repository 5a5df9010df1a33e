"""The Monte-Carlo path-tracing kernel: its counter-based RNG, the CUDA
wrapper and its plain PyTorch version (port of
``ttrt/kernels/pathtrace_pallas.py``).

``pathtrace_frame`` dispatches on the device of the scene's tensors: CPU
tensors go through ``pathtrace_frame_plain``; CUDA tensors go through
``pathtrace_frame_cuda``, which launches the hand-written kernel in
``csrc/pathtrace.cu`` (the demo ``Scene``) or
``csrc/mesh.cu::pathtrace_mesh_kernel`` (a ``MeshScene``), or raises. There
is no fallback from one to the other. Both kernels run
``csrc/pathtrace.cuh``'s estimator over their scene's tracer, and the plain
version runs it over the demo scene's linear scan or over every object of
the ``MeshScene``'s pack (the fused kernel's plain tests), which the
kernel's culled walk equals bit for bit (the lowest id wins an exact tie).

The estimator is the JAX kernel's ``_pathtrace_kernel``
(pathtrace_pallas.py:101), per ray: next-event estimation (NEE) with one
surface sample on every spherical area light and an any-hit shadow ray cut
just short of the sample, a specular-or-cosine-diffuse continuation chosen
with probability = reflectivity, Russian roulette from bounce 3, and the
procedural sky at the exit direction weighted by the throughput frozen at
the miss. The pixel is the mean of its samples, clipped to [0, 1], or
(``reduce='sum'``, pathtrace_pallas.py:372-376, what each device of the
sharded renderer returns) their unclipped sum.

Every random number is a pure hash of (frame seed, ray index, bounce,
purpose), as in the JAX kernel:

    u = u01(mix32(idx ^ mix32(seed + (bounce*64 + purpose) * 0x9E3779B9)))

with the ray index ``idx = k * (W*H) + pixel`` (sample-major). So the plain
version and the CUDA kernel draw the JAX kernel's stream draw for draw. The
hash runs in int64 tensors masked to 32 bits, since PyTorch's uint32
tensors lack most arithmetic, and a product of two 32-bit values is split
in halves so that it never leaves int64's range.

Floating point follows the demo kernel's rules (``kernels/render.py``):
constants rounded once to float32, divisions by 0-dim tensors, the
correctly rounded ``sqrt_rn``, and the fused multiply-adds that XLA:CPU
forms in the JAX kernel's compiled body written out with ``_fma`` and
``_dot3`` (the kernel's ``fmaf`` and ``dot3``). ``cos`` and ``sin`` are
PyTorch's, which on the card are CUDA's ``cosf`` and ``sinf``, the
kernel's.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ttrt_torch.config import ConfigError, RenderConfig, constants
from ttrt_torch.kernels.mesh_fused import (_shadow_blocked, mesh_trace,
                                           order_subclusters)
from ttrt_torch.kernels.render import (PLANE_FLOATS, SKY_KINDS, SPHERE_FLOATS,
                                       _dot3, _fma, _normalize3,
                                       _shadow_any_hit, _shadow_oc_terms,
                                       RENDER_LAYOUT_KEYS, _trace, _TraceOut,
                                       _tuples, pack_camera, pack_scene,
                                       sky_color)
from ttrt_torch.mesh.clusters import pack_rows
from ttrt_torch.mesh.scene import MeshScene
from ttrt_torch.scene import Scene
from ttrt_torch.utils.profiling import counted, span
from ttrt_torch.vec import Vec3, scalar_like, sqrt_rn

MASK32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9
AREA_LIGHT_FLOATS = 8
MAX_BOUNCES = 10
# the NEE purposes 10 + 3*li and 11 + 3*li meet the cosine draw's 40 at an
# 11th light (pathtrace_pallas.py:355-360)
MAX_AREA_LIGHTS = 10
MAX_PIXEL_TRACES = 0x7FFF
# purposes of the draws (pathtrace_pallas.py:157-252)
_JITTER, _NEE, _BRANCH, _COSINE, _ROULETTE = 0, 10, 30, 40, 50
_JITTER_BOUNCE = 63


# ---------------------------------------------------------------------------
# The counter-based RNG
# ---------------------------------------------------------------------------


def _mul32(x, c: int):
    """(x * c) mod 2^32 for 32-bit x (an int64 tensor or a Python int) and
    a 32-bit constant c, without leaving int64: c is split in 16-bit
    halves."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & MASK32


def mix32(x):
    """murmur3's fmix32 (pathtrace_pallas.py:70) on 32-bit values held in
    an int64 tensor or a Python int."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def u01(h: torch.Tensor) -> torch.Tensor:
    """32-bit hash -> float32 uniform in [0, 1) from its 24 high bits
    (pathtrace_pallas.py:80); exact in float32."""
    return (h >> 8).to(torch.float32) * (1.0 / 16777216.0)


def rand(idx: torch.Tensor, seed: int, bounce: int, purpose: int
         ) -> torch.Tensor:
    """One draw per ray index for (bounce, purpose) (pathtrace_pallas.py:
    127-130). ``idx`` is an int64 tensor of ray indices, ``seed`` the
    frame seed (its 32 bits)."""
    sc = ((bounce * 64 + purpose) * GOLDEN) & MASK32
    return u01(mix32(idx ^ mix32((seed + sc) & MASK32)))


def frame_seed(seed: int, t: float) -> int:
    """The JAX app's per-frame kernel seed (ttrt/app.py:142-147): the user
    seed hashed, XOR the scene time in milliseconds, ``t * 1000`` taken in
    float32 and truncated, as an int32."""
    tq = int(np.float32(t) * np.float32(1000.0)) & MASK32
    fseed = mix32(((seed & MASK32) * GOLDEN) & MASK32) ^ tq
    return fseed - (1 << 32) if fseed >= 1 << 31 else fseed


def pack_area_lights(lights, dtype=torch.float32) -> torch.Tensor:
    """(L*8,) rows: position 3, radius, color 3, intensity
    (pathtrace_pallas.py:88)."""
    return torch.stack(
        [lights.position.x, lights.position.y, lights.position.z,
         lights.radius, lights.color.x, lights.color.y, lights.color.z,
         lights.intensity], dim=-1,
    ).reshape(-1).to(dtype)


def check_supported(scene, lights, cfg: RenderConfig) -> None:
    """The gates of ``pathtrace_frame_pallas`` (pathtrace_pallas.py:
    345-360) and of the JAX app's kernel route (ttrt/app.py:73-80):
    float32, a procedural sky (the JAX kernel's only kind,
    pathtrace_pallas.py:39-43), bounce_limit <= 10, at most 10 area
    lights; the demo ``Scene`` (any sphere count) or a ``MeshScene`` with
    its cluster pack (``csrc/mesh.cu::pathtrace_mesh_kernel``, which JAX
    does not have); and the CUDA kernels' own, spp x bounces <= 0x7FFF,
    because a pixel's work packs its nearest-hit traces | hits << 16."""
    if cfg.dtype != torch.float32:
        raise ConfigError("the path-tracing kernel is float32-only")
    if isinstance(scene, MeshScene):
        if scene.clusters is None:
            raise ConfigError("the path-tracing kernel traces a MeshScene "
                              "through its cluster pack")
    elif type(scene) is not Scene:
        raise ConfigError("the path-tracing kernel traces the demo scene "
                          "or a MeshScene")
    if scene.skybox.procedural not in SKY_KINDS:
        raise ConfigError("the path-tracing kernel takes a procedural sky "
                          f"({', '.join(SKY_KINDS)})")
    if cfg.bounce_limit > MAX_BOUNCES:
        raise ConfigError(
            f"the path-tracing kernel supports bounce_limit <= {MAX_BOUNCES}")
    if lights.count > MAX_AREA_LIGHTS:
        raise ConfigError(
            f"the path-tracing kernel supports <= {MAX_AREA_LIGHTS} area "
            "lights")
    if cfg.rays_per_pixel * cfg.bounce_limit > MAX_PIXEL_TRACES:
        raise ConfigError(
            f"the path-tracing kernel takes spp x bounces <= "
            f"{MAX_PIXEL_TRACES}; got {cfg.rays_per_pixel} x "
            f"{cfg.bounce_limit}")


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------


def _uniform_sphere(idx, seed: int, bounce: int, purpose: int):
    """Uniform unit-sphere directions from two draws (z, phi)
    (pathtrace_pallas.py:132-138)."""
    z = rand(idx, seed, bounce, purpose) * 2.0 - 1.0
    phi = rand(idx, seed, bounce, purpose + 1) * (2.0 * constants.PI)
    r = sqrt_rn(torch.clamp_min(_fma(-z, z, 1.0), 0.0))
    return r * torch.cos(phi), r * torch.sin(phi), z


REDUCE = ("mean", "sum")


def _reduce_samples(c, n_samples: int, n_rows: int, width: int,
                    reduce: str):
    """Sample-major rays -> (n_rows, W): the in-order sum over the samples,
    divided by N and clipped to [0, 1] (``'mean'``), or as it is
    (``'sum'``)."""
    c = c.reshape(n_samples, n_rows, width)
    acc = c[0]
    for k in range(1, n_samples):
        acc = acc + c[k]
    if reduce == "sum":
        return acc
    return torch.clamp(acc / scalar_like(n_samples, acc), 0.0, 1.0)


def _check_reduce(reduce: str) -> None:
    if reduce not in REDUCE:
        raise ValueError(f"reduce must be 'mean' or 'sum', got {reduce!r}")


class _DemoTracer(NamedTuple):
    """The demo scene's trace and shadow test (``render._trace``,
    ``_shadow_any_hit``: the linear scan of ``DemoTracer``) on every ray
    of the frame, live or not."""

    sph_vals: list
    plane_vals: tuple

    def trace(self, alive, ox, oy, oz, dx, dy, dz) -> _TraceOut:
        return _trace(ox, oy, oz, dx, dy, dz, self.sph_vals, self.plane_vals,
                      False)

    def shadow(self, lit, hit: _TraceOut):
        """The shadow test from ``hit``'s points, any direction and
        ``tmax``."""
        oc = _shadow_oc_terms(hit.px, hit.py, hit.pz, self.sph_vals)
        return lambda lx, ly, lz, tmax: _shadow_any_hit(
            hit.px, hit.py, hit.pz, lx, ly, lz, tmax, oc, self.plane_vals)


def _scatter(at: torch.Tensor, n: int, v: torch.Tensor) -> torch.Tensor:
    """(n,) zeros of ``v``'s dtype with ``v`` at the indices ``at``."""
    out = v.new_zeros(n)
    out[at] = v
    return out


class _MeshTracer(NamedTuple):
    """A ``MeshScene``'s trace and shadow test over every object of its
    pack (``mesh_fused.mesh_trace``, ``_shadow_blocked``: the fused
    kernel's plain tests, the lowest id winning an exact tie), on the live
    rays only, as the walk's plain version. The other rays read as misses
    with zero fields, which the estimator masks."""

    sph: torch.Tensor
    tri: torch.Tensor

    def trace(self, alive, ox, oy, oz, dx, dy, dz) -> _TraceOut:
        live = torch.nonzero(alive)[:, 0]
        hit = mesh_trace(self.sph, self.tri,
                         *(v[live] for v in (ox, oy, oz, dx, dy, dz)))
        return _TraceOut(*(_scatter(live, alive.shape[0], f) for f in hit))

    def shadow(self, lit, hit: _TraceOut):
        """The shadow test from the ``lit`` rays' hit points; the others
        read unblocked."""
        at = torch.nonzero(lit)[:, 0]
        p = [v[at] for v in (hit.px, hit.py, hit.pz)]

        def blocked(lx, ly, lz, tmax):
            return _scatter(at, lit.shape[0], _shadow_blocked(
                self.sph, self.tri, *p, lx[at], ly[at], lz[at], tmax[at]))

        return blocked


def _packed(scene, lights):
    """(the packed camera, the area lights on the scene's device, the
    tracer) of ``scene``."""
    if isinstance(scene, MeshScene):
        cam = pack_camera(scene.camera, torch.float32)
        tracer = _MeshTracer(*pack_rows(scene.clusters))
    else:
        packed = pack_scene(scene, torch.float32)
        cam = packed.cam
        tracer = _DemoTracer(_tuples(packed.spheres, SPHERE_FLOATS),
                             tuple(packed.plane[i]
                                   for i in range(PLANE_FLOATS)))
    return cam, pack_area_lights(lights).to(cam.device), tracer


def _paths(scene, lights, cfg: RenderConfig, seed: int):
    """Every path of the frame, each bounce masked as in the JAX kernel:
    the per-ray radiance (3 sample-major (N*H*W,) tensors) and the work,
    (nearest-hit traces, hits, unblocked NEE shadow rays) as a (3,) int64
    tensor."""
    return _traced_paths(*_packed(scene, lights), scene.skybox, cfg, seed)


def _traced_paths(cam: torch.Tensor, al: torch.Tensor, tracer, skybox,
                  cfg: RenderConfig, seed: int,
                  rows: Optional[Sequence[int]] = None):
    """``_paths`` from the packed camera ``cam``, the area lights ``al``
    (``pack_area_lights``) and the scene's ``tracer`` (``_DemoTracer``,
    ``_MeshTracer``) under ``skybox``: ``csrc/pathtrace.cuh::trace_path``
    over the frame's rays, or with ``rows`` over those rows' rays only
    (sample-major, each with its ray index in the whole frame)."""
    W, H, N = cfg.width, cfg.height, cfg.rays_per_pixel
    seed &= MASK32
    al_vals = _tuples(al, AREA_LIGHT_FLOATS)

    # primary rays (pathtrace_pallas.py:144-168): the demo kernel's camera
    # math with a random jitter in [0, pixel)
    n_pixels = W * H
    if rows is None:
        idx = torch.arange(n_pixels * N, device=cam.device,
                           dtype=torch.int64)
    else:
        i64 = dict(device=cam.device, dtype=torch.int64)
        pix = (torch.as_tensor(rows, **i64)[:, None] * W
               + torch.arange(W, **i64)).reshape(-1)
        idx = (torch.arange(N, **i64)[:, None] * n_pixels + pix).reshape(-1)
    pix = idx % n_pixels
    f32 = torch.float32
    col = (pix % W).to(f32)
    row = (pix // W).to(f32) + cam[15]
    bx0, bx1, bx2, by0, by1, by2, bz0, bz1, bz2 = cam[:9]
    cox, coy, coz, szc, sw, sh = cam[9:15]
    w_t, h_t = scalar_like(W, cam), scalar_like(H, cam)
    jit_x = rand(idx, seed, _JITTER_BOUNCE, _JITTER) * (sw / w_t)
    jit_y = rand(idx, seed, _JITTER_BOUNCE, _JITTER + 1) * (sh / h_t)
    sxv = (col / w_t) * sw - sw / 2.0 + jit_x
    syv = -((row / h_t) * sh - sh / 2.0) + jit_y
    dx, dy, dz = _normalize3(
        sxv * bx0 + syv * by0 + szc * bz0 - cox,
        sxv * bx1 + syv * by1 + szc * bz1 - coy,
        sxv * bx2 + syv * by2 + szc * bz2 - coz,
    )
    ox, oy, oz = (c.expand_as(dx) for c in (cox, coy, coz))

    zero = torch.zeros_like(dx)
    rad = [zero, zero, zero]
    tp = [torch.ones_like(dx)] * 3
    sky_w = [zero, zero, zero]
    alive = torch.ones_like(dx, dtype=torch.bool)
    nearest = torch.zeros((), dtype=torch.int64, device=dx.device)
    hits = torch.zeros_like(nearest)
    unblocked = torch.zeros_like(nearest)

    for b in range(cfg.bounce_limit):
        hit = tracer.trace(alive, ox, oy, oz, dx, dy, dz)
        miss_now = alive & ~hit.is_hit
        add = alive & hit.is_hit
        nearest = nearest + alive.sum()
        hits = hits + add.sum()
        sky_w = [torch.where(miss_now, t, s) for t, s in zip(tp, sky_w)]

        # next-event estimation: one surface sample on every area light
        blocked_by = tracer.shadow(add, hit)
        for li, (lpx, lpy, lpz, lr, lcr, lcg, lcb, lint) in enumerate(
                al_vals):
            sx, sy, sz = _uniform_sphere(idx, seed, b, _NEE + 3 * li)
            tlx = _fma(lr, sx, lpx) - hit.px
            tly = _fma(lr, sy, lpy) - hit.py
            tlz = _fma(lr, sz, lpz) - hit.pz
            d2 = _dot3(tlx, tly, tlz, tlx, tly, tlz)
            wix, wiy, wiz = _normalize3(tlx, tly, tlz)
            ndotl = torch.clamp_min(
                _dot3(hit.nx, hit.ny, hit.nz, wix, wiy, wiz), 0.0)
            # any-hit occlusion cut just short of the light sample
            tmax = sqrt_rn(d2) * (1.0 - 5e-5)
            blocked = blocked_by(wix, wiy, wiz, tmax)
            fall = torch.clamp_max(lint / torch.clamp_min(d2, 1e-8), 1.0)
            w = torch.where(blocked, 0.0, fall * ndotl)
            aw = torch.where(add, w, 0.0)
            unblocked = unblocked + (add & ~blocked).sum()
            rad = [_fma(t * aw * lc, c, r) for t, lc, c, r in
                   zip(tp, (lcr, lcg, lcb), (hit.cr, hit.cg, hit.cb), rad)]

        # specular (probability = reflectivity) or cosine-diffuse
        spec = rand(idx, seed, b, _BRANCH) < hit.refl
        dn = 2.0 * _dot3(dx, dy, dz, hit.nx, hit.ny, hit.nz)
        spx, spy, spz = _normalize3(_fma(-dn, hit.nx, dx),
                                    _fma(-dn, hit.ny, dy),
                                    _fma(-dn, hit.nz, dz))
        usx, usy, usz = _uniform_sphere(idx, seed, b, _COSINE)
        cdx, cdy, cdz = hit.nx + usx, hit.ny + usy, hit.nz + usz
        tiny = _dot3(cdx, cdy, cdz, cdx, cdy, cdz) < 1e-8
        cdx, cdy, cdz = _normalize3(torch.where(tiny, hit.nx, cdx),
                                    torch.where(tiny, hit.ny, cdy),
                                    torch.where(tiny, hit.nz, cdz))
        ntp = [torch.where(spec, t, t * c)
               for t, c in zip(tp, (hit.cr, hit.cg, hit.cb))]

        # Russian roulette from bounce 3
        survive = True
        if b >= 3:
            maxc = torch.maximum(ntp[0], torch.maximum(ntp[1], ntp[2]))
            p_cont = torch.clamp(maxc, 0.05, 1.0)
            survive = rand(idx, seed, b, _ROULETTE) < p_cont
            inv_p = 1.0 / p_cont
            ntp = [t * inv_p for t in ntp]

        upd = add
        tp = [torch.where(upd, n, t) for n, t in zip(ntp, tp)]
        ox = torch.where(upd, hit.px, ox)
        oy = torch.where(upd, hit.py, oy)
        oz = torch.where(upd, hit.pz, oz)
        dx = torch.where(upd, torch.where(spec, spx, cdx), dx)
        dy = torch.where(upd, torch.where(spec, spy, cdy), dy)
        dz = torch.where(upd, torch.where(spec, spz, cdz), dz)
        alive = add & survive

    # the sky at the exit direction, weighted by the throughput at the miss
    sky = sky_color(dx, dy, dz, skybox, cfg.skybox_bilinear)
    return ([_fma(s, k, r) for s, k, r in zip(sky_w, sky, rad)],
            torch.stack([nearest, hits, unblocked]))


@counted
def pathtrace_frame_plain(scene, lights, cfg: RenderConfig,
                          seed: int, *, count_rays: bool = True,
                          reduce: str = "mean",
                          rows: Optional[Sequence[int]] = None
                          ) -> Tuple[Vec3, Optional[torch.Tensor]]:
    """The kernel's math in plain PyTorch on the whole (N*H*W,) ray batch.
    Returns the (H, W) frame (the per-pixel mean clipped to [0, 1], or
    with ``reduce='sum'`` the unclipped sample sum) and,
    when ``count_rays``, the frame's work as a (3,) int64 tensor:
    nearest-hit traces, hits, and the NEE shadow rays that found their
    light unblocked. Every hit casts one NEE shadow ray a light, so the
    frame traces ``nearest + hits * n_lights`` rays (``total_traces``).
    ``rows`` renders those rows of the frame only, (len(rows), W), with
    their work."""
    check_supported(scene, lights, cfg)
    _check_reduce(reduce)
    with span("pack"):
        cam, al, tracer = _packed(scene, lights)
    with span("launch"):
        color, work = _traced_paths(cam, al, tracer, scene.skybox, cfg, seed,
                                    rows)
        W, N = cfg.width, cfg.rays_per_pixel
        n_rows = cfg.height if rows is None else len(rows)
        fb = Vec3(*(_reduce_samples(c, N, n_rows, W, reduce) for c in color))
    return fb, work if count_rays else None


def total_traces(work: torch.Tensor, n_lights: int) -> int:
    """Rays a frame traces, from its work (nearest-hit traces, hits, ...):
    one nearest-hit trace a bounce and one NEE shadow ray a light a
    hit."""
    return int(work[0]) + int(work[1]) * n_lights


# ---------------------------------------------------------------------------
# The CUDA kernel's wrapper
# ---------------------------------------------------------------------------


def _device_lights(lights, device) -> torch.Tensor:
    """``pack_area_lights(lights)``, which must be on ``device``."""
    al = pack_area_lights(lights)
    if al.device != device:
        raise ValueError("the area lights and the scene must be on one "
                         f"device, got {al.device} and {device}")
    return al


def _outputs(cfg: RenderConfig, device):
    """The kernels' (3, H, W) frame and (2, H, W) counts, uninitialized."""
    H, W = cfg.height, cfg.width
    return (torch.empty((3, H, W), dtype=torch.float32, device=device),
            torch.empty((2, H, W), dtype=torch.int32, device=device))


def _launch_demo(scene: Scene, lights, cfg: RenderConfig, seed: int,
                 reduce: str):
    """``ttrt_pathtrace`` (csrc/pathtrace.cu) on the demo scene, its
    camera, spheres, plane and lights in one buffer: (its return code,
    the frame, the counts)."""
    from ttrt_torch.kernels import build

    with span("pack"):
        packed = pack_scene(scene, torch.float32)
        al = _device_lights(lights, packed.cam.device)
        buf = torch.cat([packed.cam, packed.spheres, packed.plane,
                         al]).contiguous()
    with span("launch"):
        lib = build.load()
        out, counts = _outputs(cfg, buf.device)
        return lib.ttrt_pathtrace(
            buf.data_ptr(), scene.spheres.count, lights.count, cfg.width,
            cfg.height, cfg.rays_per_pixel, cfg.bounce_limit,
            SKY_KINDS[scene.skybox.procedural], scene.skybox.dim,
            int(cfg.skybox_bilinear), int(reduce == "sum"), seed & MASK32,
            out.data_ptr(), counts.data_ptr(),
            torch.cuda.current_stream(buf.device).cuda_stream), out, counts


def _launch_mesh(scene: MeshScene, lights, cfg: RenderConfig, seed: int,
                 reduce: str):
    """``ttrt_pathtrace_mesh`` (csrc/mesh.cu::pathtrace_mesh_kernel) on a
    ``MeshScene``: its pack's kernel tables and the per-frame visit order
    of ``render_band_mesh_fused_cuda``, the packed camera and lights; as
    ``_launch_demo``."""
    from ttrt_torch.kernels import build

    pack, tab = scene.clusters, scene.clusters.tables
    with span("pack"):
        order = order_subclusters(pack, scene.camera.frame.origin)
        cam = pack_camera(scene.camera, torch.float32).contiguous()
        al = _device_lights(lights, cam.device)
    with span("launch"):
        lib = build.load()
        out, counts = _outputs(cfg, cam.device)
        return lib.ttrt_pathtrace_mesh(
            cam.data_ptr(), al.data_ptr(), lights.count,
            tab.sph.data_ptr(), tab.sph_mat.data_ptr(),
            tab.sph_spec.data_ptr(), tab.sph_id.data_ptr(),
            tab.tri.data_ptr(), tab.tri_nrm.data_ptr(),
            tab.tri_mat.data_ptr(), tab.tri_spec.data_ptr(),
            tab.tri_id.data_ptr(), tab.qbox.data_ptr(), order.data_ptr(),
            tab.kb_sph, tab.kb_tri, cfg.width, cfg.height,
            cfg.rays_per_pixel, cfg.bounce_limit,
            SKY_KINDS[scene.skybox.procedural], scene.skybox.dim,
            int(cfg.skybox_bilinear), int(reduce == "sum"), seed & MASK32,
            out.data_ptr(), counts.data_ptr(),
            torch.cuda.current_stream(cam.device).cuda_stream), out, counts


@counted
def pathtrace_frame_cuda(scene, lights, cfg: RenderConfig, seed: int,
                         *, count_rays: bool = True, reduce: str = "mean"
                         ) -> Tuple[Vec3, Optional[torch.Tensor]]:
    """Path-trace one frame with a CUDA kernel: the demo scene's
    (csrc/pathtrace.cu) or a ``MeshScene``'s
    (csrc/mesh.cu::pathtrace_mesh_kernel, the quarter boxes staged in
    shared memory in the frame's visit order). One thread per (pixel,
    sample), a pixel's samples in one block and added there in sample
    order; writes the (3, H, W) clipped sample mean (or with
    ``reduce='sum'`` the unclipped sample sum) and the pixel's work,
    nearest-hit traces | hits << 16 and the unblocked NEE shadow rays
    (``pathtrace_layout`` gives the launch shape); the frame's work is
    ``pathtrace_frame_plain``'s. Raises on anything the kernel does not
    take, CPU tensors included."""
    check_supported(scene, lights, cfg)
    _check_reduce(reduce)
    dev = scene.spheres.radius.device
    if dev.type != "cuda":
        raise ValueError(f"pathtrace_frame_cuda needs CUDA tensors, got {dev}")
    launch = _launch_mesh if isinstance(scene, MeshScene) else _launch_demo
    rc, out, counts = launch(scene, lights, cfg, seed, reduce)
    if rc != 0:
        raise RuntimeError(
            f"path-tracing kernel launch failed: CUDA error {rc}")
    fb = Vec3(out[0], out[1], out[2])
    if not count_rays:
        return fb, None
    c = counts.to(torch.int64)
    return fb, torch.stack([(c[0] & 0xFFFF).sum(), (c[0] >> 16).sum(),
                            c[1].sum()])


def pathtrace_layout(scene, lights, cfg: RenderConfig,
                     reduce: str = "mean") -> dict:
    """The launch shape ``pathtrace_frame_cuda`` takes
    (``ttrt_pathtrace_layout``, or ``ttrt_pathtrace_mesh_layout`` for a
    ``MeshScene``), with ``render_layout``'s keys: the sample threads of a
    pixel, pixels, threads and dynamic shared bytes of a block, the
    blocks, whether the scene (a ``MeshScene``: its quarter boxes) is
    staged in shared memory, the blocks an SM holds and the SMs (hence
    ``waves``), and the kernel's registers and local (spill) bytes a
    thread. Needs a CUDA device."""
    from ttrt_torch.kernels import build

    _check_reduce(reduce)
    if isinstance(scene, MeshScene):
        tab = scene.clusters.tables
        return build.layout(
            "ttrt_pathtrace_mesh_layout", RENDER_LAYOUT_KEYS, tab.kb_sph,
            tab.kb_tri, lights.count, cfg.width, cfg.height,
            cfg.rays_per_pixel)
    return build.layout(
        "ttrt_pathtrace_layout", RENDER_LAYOUT_KEYS, scene.spheres.count,
        lights.count, cfg.width, cfg.height, cfg.rays_per_pixel,
        int(reduce == "sum"))


def pathtrace_frame(scene, lights, cfg: RenderConfig, seed: int, *,
                    count_rays: bool = True, reduce: str = "mean"
                    ) -> Tuple[Vec3, Optional[torch.Tensor]]:
    """Path-trace one frame on the device that holds the scene: the plain
    version for CPU tensors, the CUDA kernel for CUDA tensors."""
    fn = (pathtrace_frame_plain
          if scene.spheres.radius.device.type == "cpu"
          else pathtrace_frame_cuda)
    return fn(scene, lights, cfg, seed, count_rays=count_rays, reduce=reduce)
