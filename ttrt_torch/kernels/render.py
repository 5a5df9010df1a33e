"""The demo-scene render kernels: scene packing, the CUDA wrappers, and
their plain PyTorch versions (port of ``ttrt/kernels/render_pallas.py``).

Four entry points, each dispatching on the device of the scene's tensors
(CPU tensors go through the plain version; CUDA tensors through the
wrapper, which launches its hand-written kernel in ``csrc/render.cu`` or
raises; there is no fallback from one to the other):

- ``render_frame``: the frame, under a procedural sky or an image cubemap,
  nearest or bilinear (``_render_kernel``, render_pallas.py:894);
- ``render_band``: a band of its rows x a slice of its AA samples, the
  samples averaged or summed (``render_band_pallas``, :1357): each
  device's share of a sharded frame (``parallel/sharding.py``);
- ``render_frame_pixel_rate``: the same frame with its counts summed per
  pixel in 16|16 fields (``_render_kernel_acc``, :612);
- ``sky_weights``: the per-ray sky weight of the bounce chain, with no
  lighting (``_sky_weight_kernel``, :860).

``render_band_plain`` (and its whole frame, ``render_frame_plain``)
mirrors the kernel's math op for op, as the JAX
kernel ``_render_kernel`` (render_pallas.py:894) computes it: the same
sample-major ray order, the same restructured predicates (sqrt-free hit
tests, a shared ``0.5/a``, normalize by multiplying with the reciprocal
square root, any-hit shadow rays with a distance cutoff) and the same masked
bounce loop. It is the reference the CUDA kernel is held to on the card,
and the path that runs on the CPU.

Semantics are the reference's (TerminalRayTracer.c:638-1065): sphere/plane
intersection quirks, EPSILON back-offset, checker parity, un-clamped-below
n.l, the point-light occlusion comparison and contribution-weighted bounce
accumulation.

Floating point follows the JAX package: every Python constant is rounded
once to float32 (JAX's weak-typed scalars), and every division by a
constant divides by a float32 tensor (``scalar_like``), because PyTorch's
CUDA ``tensor / python_scalar`` multiplies by a rounded reciprocal instead.
The reciprocal square root is ``1 / sqrt(x)`` with a correctly rounded
``sqrt`` (``sqrt_rn``) and IEEE division, here and in the kernel.

XLA:CPU, which computes the JAX oracle, contracts ``a*b + c`` into one
fused multiply-add inside its compiled bounce loop (for ``a*b + c*d`` it
fuses the left product). The port writes those contractions out: ``_fma``
and ``_dot3`` here, ``fmaf`` and ``dot3`` in the kernel, which is built
with ``--fmad=false`` so that the compiler adds none of its own. Without
them the hit-point offset term ``c = |p - center|^2 - r^2``, a cancellation
of a few float32 ulps, changes sign differently from the oracle and flips
shadows on pixels that no knife-edge class covers. Ray generation (but
for its normalize) and the sky fold stay uncontracted, as the oracle
computes them op by op; their last-bit differences are direction noise
that the knife-edge classes cover. So do the image sky's texel unpacking
(a true division by 255) and its bilinear lerps: the oracle computes its
sky eagerly, op by op (JAX's textured Pallas path folds the sky in a jitted
epilogue, where XLA:CPU multiplies by 1/255 and contracts the lerps and the
fold, up to an ulp away from the oracle).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ttrt_torch.config import ConfigError, RenderConfig, constants
from ttrt_torch.render.skybox import CUBEMAP_AXES, U_AXIS, V_AXIS, _unpack
from ttrt_torch.scene import Scene
from ttrt_torch.vec import Vec3, scalar_like, sqrt_rn

CAM_FLOATS = 17
SPHERE_FLOATS = 9
PLANE_FLOATS = 16
DLIGHT_FLOATS = 6
PLIGHT_FLOATS = 7

# procedural skies the kernels evaluate in place of a texel fetch, and the
# kind of an image cubemap, whose texels the kernels load
SKY_KINDS = {"colors": 0, "uv_checker": 1}
SKY_IMAGE = 2

_F32_MAX = torch.finfo(torch.float32).max
# EPSILON rounded to float32 once, as JAX's weak-typed scalar is (_fma
# computes in float64, where a Python float would keep all its digits)
_F32_EPSILON = float(torch.tensor(constants.EPSILON, dtype=torch.float32))


# ---------------------------------------------------------------------------
# Scene packing: flat float32 tensors, built on the scene's device
# ---------------------------------------------------------------------------


class PackedScene(NamedTuple):
    """Flat scalar views of the scene, the layout of the JAX kernel's SMEM
    tables."""

    cam: torch.Tensor  # (17,) bx3 by3 bz3 origin3 -sz sw sh row_off samp_off
    spheres: torch.Tensor  # (n*9,) cx cy cz r cr cg cb refl spec
    plane: torch.Tensor  # (16,) p3 n3 even(rgb,refl) odd(rgb,refl) spec e/o
    dlights: torch.Tensor  # (n_dl*6,) normalized -dir (guarded) 3, color 3
    plights: torch.Tensor  # (n_pl*7,) pos3 color3 intensity


def pack_camera(cam, dtype, row_offset: float = 0.0,
                sample_offset: float = 0.0) -> torch.Tensor:
    """(17,) camera row: basis (9), origin (3), -screen_distance,
    screen_w/h, row_offset, sample_offset. The offsets shift the kernel's
    ray-generation rows and AA-sample indices (a band or sample slice of
    the frame)."""
    f = cam.frame
    like = f.origin.to(dtype)
    tail = torch.stack([
        -cam.screen_distance.to(dtype),
        cam.screen_width.to(dtype),
        cam.screen_height.to(dtype),
        scalar_like(row_offset, like),
        scalar_like(sample_offset, like),
    ])
    return torch.cat([f.basis.reshape(-1).to(dtype), like, tail])


def pack_dlights(dl, dtype) -> torch.Tensor:
    """(n_dl*6,) rows: pre-negated + guard-normalized direction (identical
    bits to the in-loop normalize at TerminalRayTracer.c:905), then color."""
    ndir = (-dl.direction).normalize()
    return torch.stack(
        [ndir.x, ndir.y, ndir.z, dl.color.x, dl.color.y, dl.color.z], dim=-1
    ).reshape(-1).to(dtype)


def pack_plights(pls, dtype) -> torch.Tensor:
    """(n_pl*7,) rows: position, color, intensity."""
    return torch.stack(
        [pls.position.x, pls.position.y, pls.position.z,
         pls.color.x, pls.color.y, pls.color.z, pls.intensity], dim=-1,
    ).reshape(-1).to(dtype)


def pack_scene(scene: Scene, dtype, row_offset: float = 0.0,
               sample_offset: float = 0.0) -> PackedScene:
    """Flatten the scene into the kernel's table layout, on the scene's
    device (a frame needs no host-to-device copy)."""
    sph = scene.spheres
    m = sph.material
    sph_flat = torch.stack(
        [sph.center.x, sph.center.y, sph.center.z, sph.radius,
         m.color.x, m.color.y, m.color.z, m.reflectivity, m.specularity],
        dim=-1,
    ).reshape(-1).to(dtype)
    g = scene.ground
    e, o = g.even_material, g.odd_material
    plane_flat = torch.stack(
        [g.point.x, g.point.y, g.point.z, g.normal.x, g.normal.y, g.normal.z,
         e.color.x, e.color.y, e.color.z, e.reflectivity,
         o.color.x, o.color.y, o.color.z, o.reflectivity,
         e.specularity, o.specularity]
    ).to(dtype)
    return PackedScene(
        pack_camera(scene.camera, dtype, row_offset, sample_offset),
        sph_flat, plane_flat,
        pack_dlights(scene.directional_lights, dtype),
        pack_plights(scene.point_lights, dtype),
    )


def sky_kind(skybox) -> int:
    """The kernels' sky kind: a procedural pattern's, or SKY_IMAGE."""
    if skybox.procedural is None:
        return SKY_IMAGE
    return SKY_KINDS[skybox.procedural]


def check_sky(scene) -> None:
    """The kernels evaluate a procedural sky in place and load an image
    cubemap's texels, nearest or bilinear, at any ``dim``: JAX's cap of
    dim <= 591 (render_pallas.py:1315-1325) comes from the texel index it
    packs into bits 10..30 of an int32 count stream, which the port does
    not. A tag that names no pattern is refused."""
    tag = scene.skybox.procedural
    if tag is not None and tag not in SKY_KINDS:
        raise ConfigError(f"unknown procedural sky {tag!r} (the kernels "
                          f"evaluate {', '.join(SKY_KINDS)})")


def check_supported(scene: Scene, cfg: RenderConfig) -> None:
    """The gates of ``render_frame_pallas`` (render_pallas.py:1292-1325)
    that this port keeps: float32, bounce_limit <= 16 (the per-ray trace
    counts pack 5-bit fields), and a sky the kernels take."""
    if cfg.dtype != torch.float32:
        raise ConfigError("the render kernel is float32-only")
    check_sky(scene)
    if cfg.bounce_limit > 16:
        raise ConfigError("the render kernel supports bounce_limit <= 16")


def check_ghost_sky(scene: Scene, cfg: RenderConfig, ghost_sky) -> None:
    """JAX's checks of ``render_frame_pallas(..., ghost_sky=...)``: ignored
    under a procedural sky (render_pallas.py:1043); on an image cubemap,
    refused with ``--bilinear`` (:1294-1298) and unless it is 'colors'
    (:1044-1047).

    No renderer of the port takes ``ghost_sky``. JAX's 'colors' split
    renders an image sky with a decoy procedural sky plus a second,
    lighting-free kernel for the sky weights (``_sky_weight_kernel``,
    ported as ``sky_weights``); its frame is the plain textured frame to
    1-2 ulp before quantization (render_pallas.py:972-976), and it insured
    against a Mosaic scheduling cliff that has no counterpart on the GPU,
    so the textured kernel serves every image sky. This validator keeps
    the option's contract for a caller that carries it over."""
    if scene.skybox.procedural is not None:
        return
    if cfg.skybox_bilinear and ghost_sky:
        raise ConfigError("ghost decoy sky does not serve --bilinear")
    if ghost_sky is not None and ghost_sky != "colors":
        raise ConfigError(
            f"ghost decoy sky must be 'colors', got {ghost_sky!r}")


# a pixel's 16|16 count sums hold at most 0xFFFF bounces
MAX_PIXEL_BOUNCES = 0xFFFF


def check_pixel_rate(scene: Scene, cfg: RenderConfig) -> None:
    """The gates of the pixel-rate layout: ``check_supported``'s, a
    procedural sky, as JAX's ``_render_kernel_acc`` takes
    (render_pallas.py:624-631), and spp x bounces <= 0xFFFF, so that a
    pixel's 16-bit bounce and hit sums cannot overflow."""
    check_supported(scene, cfg)
    if scene.skybox.procedural is None:
        raise ConfigError("the pixel-rate layout takes a procedural sky "
                          f"({', '.join(SKY_KINDS)})")
    if cfg.rays_per_pixel * cfg.bounce_limit > MAX_PIXEL_BOUNCES:
        raise ConfigError(
            f"the pixel-rate layout takes spp x bounces <= "
            f"{MAX_PIXEL_BOUNCES}; got {cfg.rays_per_pixel} x "
            f"{cfg.bounce_limit}")


# ---------------------------------------------------------------------------
# The plain version: the kernel's math on whole ray batches
# ---------------------------------------------------------------------------


def _fma(a, b, c):
    """``fmaf(a, b, c)``: a*b + c rounded once to float32. Emulated in
    float64, where the product of two float32 values is exact; the sum then
    rounds twice, which differs from one rounding only on exact ties. With
    a float64 operand (the eager integrator's float64 mode) the result
    stays float64, a*b + c as written."""
    f64 = lambda v: v.double() if isinstance(v, torch.Tensor) else v  # noqa: E731
    out = f64(a) * f64(b) + f64(c)
    if any(isinstance(v, torch.Tensor) and v.dtype == torch.float64
           for v in (a, b, c)):
        return out
    return out.float()


def _dot3(ax, ay, az, bx, by, bz):
    """``ax*bx + ay*by + az*bz`` as XLA:CPU contracts it:
    ``fma(az, bz, fma(ax, bx, ay*by))``."""
    return _fma(az, bz, _fma(ax, bx, ay * by))


def _normalize3(x, y, z):
    """Guarded normalize (TerminalRayTracer.c:439-450): identity when the
    length is <= 1e-4. Compares the SQUARED length, then multiplies by the
    reciprocal square root."""
    len2 = _dot3(x, y, z, x, y, z)
    ok = len2 > constants.NORMALIZE_GUARD * constants.NORMALIZE_GUARD
    inv = torch.where(ok, 1.0 / sqrt_rn(torch.where(ok, len2, 1.0)), 1.0)
    return x * inv, y * inv, z * inv


class _TraceOut(NamedTuple):
    is_hit: torch.Tensor
    px: torch.Tensor  # EPSILON-offset hit point (miss: ray origin)
    py: torch.Tensor
    pz: torch.Tensor
    nx: torch.Tensor  # normalized hit normal (miss: ray direction)
    ny: torch.Tensor
    nz: torch.Tensor
    cr: torch.Tensor  # material color (miss lanes: masked out)
    cg: torch.Tensor
    cb: torch.Tensor
    refl: torch.Tensor  # reflectivity (miss: 0)
    spec: torch.Tensor  # specularity (zeros unless want_spec)


def _trace(ox, oy, oz, dx, dy, dz, sph_vals, plane_vals,
           want_spec: bool) -> _TraceOut:
    """Nearest-hit trace (trace_ray, TerminalRayTracer.c:793-889) as the
    JAX kernel restructures it (render_pallas.py:194): the sphere test
    ``disc >= 0 && t0 > 0`` is ``disc >= 0 && b < 0 && c > 0`` (no sqrt or
    division), the nearest-object compare uses t (monotonic in the C's
    squared distance for one origin), and the winner's point and normal
    are computed once after the scan. Ties keep the first object."""
    a = _dot3(dx, dy, dz, dx, dy, dz)
    inv2a = scalar_like(0.5, a) / a

    best_t = torch.full_like(dx, _F32_MAX)
    zero = torch.zeros_like(dx)
    bcx = bcy = bcz = bcr = bcg = bcb = brefl = bspec = zero
    hit_sphere = torch.zeros_like(dx, dtype=torch.bool)

    for (cx, cy, cz, r, scr, scg, scb, srefl, sspec) in sph_vals:
        ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
        b = 2.0 * _dot3(ocx, ocy, ocz, dx, dy, dz)
        c = _fma(-r, r, _dot3(ocx, ocy, ocz, ocx, ocy, ocz))
        disc = _fma(b, b, -(4.0 * a * c))
        hit = (disc >= 0.0) & (b < 0.0) & (c > 0.0)
        t0 = (-b - sqrt_rn(torch.clamp_min(disc, 0.0))) * inv2a
        take = hit & (t0 < best_t)
        best_t = torch.where(take, t0, best_t)
        hit_sphere = hit_sphere | take
        bcx = torch.where(take, cx, bcx)
        bcy = torch.where(take, cy, bcy)
        bcz = torch.where(take, cz, bcz)
        bcr = torch.where(take, scr, bcr)
        bcg = torch.where(take, scg, bcg)
        bcb = torch.where(take, scb, bcb)
        brefl = torch.where(take, srefl, brefl)
        if want_spec:
            bspec = torch.where(take, sspec, bspec)

    # ground plane (TerminalRayTracer.c:830-853)
    (ppx, ppy, ppz, pnx, pny, pnz,
     ecr, ecg, ecb, erefl, ocr, ocg, ocb, orefl, espec, ospec) = plane_vals
    denom = _dot3(dx, dy, dz, pnx, pny, pnz)
    safe = torch.where(denom == 0.0, 1.0, denom)
    tp = _dot3(ppx - ox, ppy - oy, ppz - oz, pnx, pny, pnz) / safe
    phit = (torch.abs(denom) > constants.PLANE_DENOM_EPS) & (
        tp > constants.PLANE_T_EPS)
    take_p = phit & (tp < best_t)
    best_t = torch.where(take_p, tp, best_t)
    hit_any = hit_sphere | take_p

    t = torch.where(hit_any, best_t, 0.0)
    px, py, pz = _fma(t, dx, ox), _fma(t, dy, oy), _fma(t, dz, oz)

    # checker parity (TerminalRayTracer.c:850): float -> int truncation
    parity = (torch.floor(px) + torch.floor(pz)).to(torch.int32) & 1
    odd = parity == 1
    cr = torch.where(take_p, torch.where(odd, ocr, ecr), bcr)
    cg = torch.where(take_p, torch.where(odd, ocg, ecg), bcg)
    cb = torch.where(take_p, torch.where(odd, ocb, ecb), bcb)
    refl = torch.where(take_p, torch.where(odd, orefl, erefl), brefl)
    if want_spec:
        bspec = torch.where(take_p, torch.where(odd, ospec, espec), bspec)
    nxr = torch.where(take_p, pnx, px - bcx)
    nyr = torch.where(take_p, pny, py - bcy)
    nzr = torch.where(take_p, pnz, pz - bcz)

    # hit fixups (TerminalRayTracer.c:858-886): EPSILON back-offset through
    # a guarded normalize; on miss point = origin, normal = direction
    tox, toy, toz = _normalize3(ox - px, oy - py, oz - pz)
    eps = _F32_EPSILON
    px = torch.where(hit_any, _fma(tox, eps, px), ox)
    py = torch.where(hit_any, _fma(toy, eps, py), oy)
    pz = torch.where(hit_any, _fma(toz, eps, pz), oz)
    nx, ny, nz = _normalize3(torch.where(hit_any, nxr, dx),
                             torch.where(hit_any, nyr, dy),
                             torch.where(hit_any, nzr, dz))
    refl = torch.where(hit_any, refl, 0.0)
    return _TraceOut(hit_any, px, py, pz, nx, ny, nz, cr, cg, cb, refl, bspec)


def _shadow_oc_terms(px, py, pz, sph_vals):
    """Per-sphere (oc vector, c term) for a shadow ORIGIN, shared by every
    shadow ray cast from the same hit point."""
    out = []
    for (cx, cy, cz, r, *_mat) in sph_vals:
        ocx, ocy, ocz = px - cx, py - cy, pz - cz
        out.append((ocx, ocy, ocz,
                    _fma(-r, r, _dot3(ocx, ocy, ocz, ocx, ocy, ocz))))
    return out


def _shadow_any_hit(px, py, pz, ldx, ldy, ldz, tmax, oc_terms, plane_vals):
    """Occlusion-only trace along a UNIT direction (so the quadratic's
    ``a`` is 1): does any object block the ray before ``tmax`` (None: no
    cutoff, for directional lights)? The reference's shadow rays are
    nearest-hit traces whose only consumed outputs are hit/no-hit and, for
    point lights, blocker distance vs light distance
    (TerminalRayTracer.c:907, 937-942); "nearest blocker closer than the
    light" equals "any blocker closer than the light"."""
    blocked = torch.zeros_like(px, dtype=torch.bool)
    for (ocx, ocy, ocz, c) in oc_terms:
        b = 2.0 * _dot3(ocx, ocy, ocz, ldx, ldy, ldz)
        disc = _fma(b, b, -(4.0 * c))
        hit = (disc >= 0.0) & (b < 0.0) & (c > 0.0)
        if tmax is not None:
            # t0 < tmax  <=>  sqrt(disc) > -b - 2*tmax, squared on the
            # positive branch
            rhs = -b - 2.0 * tmax
            hit = hit & ((rhs < 0.0) | (disc > rhs * rhs))
        blocked = blocked | hit

    (ppx, ppy, ppz, pnx, pny, pnz, *_rest) = plane_vals
    denom = _dot3(ldx, ldy, ldz, pnx, pny, pnz)
    safe = torch.where(denom == 0.0, 1.0, denom)
    tp = _dot3(ppx - px, ppy - py, ppz - pz, pnx, pny, pnz) / safe
    phit = (torch.abs(denom) > constants.PLANE_DENOM_EPS) & (
        tp > constants.PLANE_T_EPS)
    if tmax is not None:
        phit = phit & (tp < tmax)
    return blocked | phit


def _clamp01(v):
    return torch.clamp(v, 0.0, 1.0)


def _apply_lighting(px, py, pz, nx, ny, nz, mcr, mcg, mcb, dl_vals, pl_vals,
                    blocked_by, view=None, mspec=None):
    """Diffuse shading with any-hit shadow traces (apply_lighting,
    TerminalRayTracer.c:894-963); returns lit (r, g, b) clamped to [0, 1].
    ``blocked_by(ldx, ldy, ldz, tmax)`` is the shadow test from this hit
    point along a unit direction (``tmax`` None: no cutoff).
    ``view``/``mspec`` switch on the Blinn-Phong specular extension
    (TerminalRayTracer.c:913-916, 947-950)."""
    outr = torch.zeros_like(px)
    outg = torch.zeros_like(px)
    outb = torch.zeros_like(px)

    for (lx, ly, lz, lcr, lcg, lcb) in dl_vals:
        blocked = blocked_by(lx, ly, lz, None)
        ndotl = torch.clamp_max(_dot3(nx, ny, nz, lx, ly, lz), 1.0)
        cr, cg, cb = lcr * ndotl * mcr, lcg * ndotl * mcg, lcb * ndotl * mcb
        if view is not None:
            hx, hy, hz = _normalize3(lx + view[0], ly + view[1], lz + view[2])
            s = torch.pow(_clamp01(_dot3(nx, ny, nz, hx, hy, hz)), mspec)
            cr, cg, cb = _fma(lcr, s, cr), _fma(lcg, s, cg), _fma(lcb, s, cb)
        outr = outr + torch.where(blocked, 0.0, cr)
        outg = outg + torch.where(blocked, 0.0, cg)
        outb = outb + torch.where(blocked, 0.0, cb)

    for (lpx, lpy, lpz, lcr, lcg, lcb, inten) in pl_vals:
        lvx, lvy, lvz = lpx - px, lpy - py, lpz - pz
        light_d2 = _dot3(lvx, lvy, lvz, lvx, lvy, lvz)
        intensity = _clamp01(inten / light_d2)
        ldx, ldy, ldz = _normalize3(lvx, lvy, lvz)
        # a blocker beyond the light does not occlude (c:942)
        tmax = sqrt_rn(light_d2)
        blocked = blocked_by(ldx, ldy, ldz, tmax)
        ndotl = torch.clamp_max(_dot3(nx, ny, nz, ldx, ldy, ldz), 1.0)
        scale = intensity * ndotl
        cr, cg, cb = lcr * scale * mcr, lcg * scale * mcg, lcb * scale * mcb
        if view is not None:
            hx, hy, hz = _normalize3(ldx + view[0], ldy + view[1],
                                     ldz + view[2])
            s = intensity * torch.pow(
                _clamp01(_dot3(nx, ny, nz, hx, hy, hz)), mspec)
            cr, cg, cb = _fma(lcr, s, cr), _fma(lcg, s, cg), _fma(lcb, s, cb)
        outr = outr + torch.where(blocked, 0.0, cr)
        outg = outg + torch.where(blocked, 0.0, cg)
        outb = outb + torch.where(blocked, 0.0, cb)

    return _clamp01(outr), _clamp01(outg), _clamp01(outb)  # c:960


def _select(face, column):
    """Per-face constant of a 6-entry table column."""
    out = torch.full_like(face, float(column[0]), dtype=torch.float32)
    for f in range(1, 6):
        out = torch.where(face == f, float(column[f]), out)
    return out


def _sky_face_uv_cont(dx, dy, dz):
    """(face, u, v) of get_skybox_color (TerminalRayTracer.c:700-776):
    strict-greater face scan, the per-face uv fixups folded into
    U_AXIS/V_AXIS, u and v clamped to [-0.5, 0.5]."""
    ddx, ddy, ddz = _normalize3(dx, dy, dz)
    best, face = None, None
    for f in range(6):
        ax, ay, az = (float(v) for v in CUBEMAP_AXES[f])
        d = ddx * ax + ddy * ay + ddz * az
        if best is None:
            best, face = d, torch.zeros_like(dx, dtype=torch.int32)
        else:
            m = d > best
            best = torch.where(m, d, best)
            face = torch.where(m, f, face)

    inv = 1.0 / best
    sx, sy, sz = ddx * inv, ddy * inv, ddz * inv
    axx, axy, axz = (_select(face, CUBEMAP_AXES[:, i]) for i in range(3))
    # the C recomputes t = dot(scaled, axis) (TerminalRayTracer.c:720)
    t2 = sx * axx + sy * axy + sz * axz
    ox = (sx - t2 * axx) * 0.5
    oy = (sy - t2 * axy) * 0.5
    oz = (sz - t2 * axz) * 0.5
    u = (ox * _select(face, U_AXIS[:, 0]) + oy * _select(face, U_AXIS[:, 1])
         + oz * _select(face, U_AXIS[:, 2]))
    v = (ox * _select(face, V_AXIS[:, 0]) + oy * _select(face, V_AXIS[:, 1])
         + oz * _select(face, V_AXIS[:, 2]))
    return face, torch.clamp(u, -0.5, 0.5), torch.clamp(v, -0.5, 0.5)


def _sky_face_uv(dx, dy, dz, dim: int):
    """(face, ui, vi) nearest texel: the reference's int truncation
    (TerminalRayTracer.c:778-788) clamped to dim-1."""
    face, u, v = _sky_face_uv_cont(dx, dy, dz)
    ui = torch.clamp_max(((u + 0.5) * dim).to(torch.int32), dim - 1)
    vi = torch.clamp_max(((v + 0.5) * dim).to(torch.int32), dim - 1)
    return face, ui, vi


# face colors of the 'colors' cubemap, /255 (assets.make_colors_skybox)
_FACE_COLORS01 = (
    (1.0, 0.0, 0.0),
    (0.0, 1.0, 1.0),
    (0.0, 1.0, 0.0),
    (1.0, 0.0, 1.0),
    (0.0, 0.0, 1.0),
    (1.0, 1.0, 0.0),
)


def _procedural_texel(face, ui, vi, dim: int, kind: str):
    """Texel (face, row vi, column ui) of a procedural cubemap,
    bit-identical to the generators in assets.py: the same float32 op
    order, then their (x*255) truncation and /255."""
    hue = [_select(face, [c[ch] for c in _FACE_COLORS01]) for ch in range(3)]
    if kind == "colors":
        return tuple(hue)  # texels are exactly 0 or 255
    u01 = ui.to(torch.float32) / scalar_like(dim, hue[0])
    v01 = vi.to(torch.float32) / scalar_like(dim, hue[0])
    checker = torch.remainder(torch.floor(u01 * 8.0) + torch.floor(v01 * 8.0),
                              2.0)
    shade = 0.25 + 0.5 * checker
    r = _clamp01(hue[0] * shade + 0.3 * u01)
    g = _clamp01(hue[1] * shade + 0.3 * v01)
    b = hue[2] * shade
    c255 = scalar_like(255.0, b)
    q = lambda x: (x * 255.0).to(torch.int32).to(torch.float32) / c255  # noqa: E731
    return q(r), q(g), q(b)


def _image_texel(flat: torch.Tensor, face, ui, vi, dim: int):
    """Texel (face, row vi, column ui) of an image cubemap's packed table
    as float32 (r, g, b): the JAX oracle's eager gather and ``_unpack``, a
    true division by 255 (render/skybox.py)."""
    c = _unpack(flat[((face.long() * dim + vi) * dim + ui)], torch.float32)
    return c.x, c.y, c.z


def _sky_nearest(dx, dy, dz, texel, dim: int):
    """The sky along (dx, dy, dz) at the nearest texel; ``texel(face, ui,
    vi)`` gives its (r, g, b)."""
    return texel(*_sky_face_uv(dx, dy, dz, dim))


def _sky_bilinear(dx, dy, dz, texel, dim: int):
    """The 4-tap bilinear sky (render_pallas.py:568, :485-502): the texels
    at the four texel centers around (u, v), clamped within the face,
    blended in ``sample_skybox(bilinear=True)``'s lerp order."""
    face, u, v = _sky_face_uv_cont(dx, dy, dz)
    fu = (u + 0.5) * dim - 0.5
    fv = (v + 0.5) * dim - 0.5
    u0 = torch.clamp(torch.floor(fu).to(torch.int32), 0, dim - 1)
    v0 = torch.clamp(torch.floor(fv).to(torch.int32), 0, dim - 1)
    u1 = torch.clamp_max(u0 + 1, dim - 1)
    v1 = torch.clamp_max(v0 + 1, dim - 1)
    wu = torch.clamp(fu - u0.to(torch.float32), 0.0, 1.0)
    wv = torch.clamp(fv - v0.to(torch.float32), 0.0, 1.0)
    c00 = texel(face, u0, v0)
    c01 = texel(face, u1, v0)
    c10 = texel(face, u0, v1)
    c11 = texel(face, u1, v1)
    out = []
    for ch in range(3):
        top = c00[ch] * (1.0 - wu) + c01[ch] * wu
        bot = c10[ch] * (1.0 - wu) + c11[ch] * wu
        out.append(top * (1.0 - wv) + bot * wv)
    return tuple(out)


def sky_color(dx, dy, dz, skybox, bilinear: bool):
    """The sky along (dx, dy, dz), nearest or bilinear: a procedural
    pattern evaluated in place, or an image cubemap's texels gathered."""
    dim = skybox.dim
    if skybox.procedural is None:
        flat = skybox.packed.reshape(-1)
        texel = lambda f, u, v: _image_texel(flat, f, u, v, dim)  # noqa: E731
    else:
        texel = lambda f, u, v: _procedural_texel(  # noqa: E731
            f, u, v, dim, skybox.procedural)
    return (_sky_bilinear if bilinear else _sky_nearest)(dx, dy, dz, texel,
                                                         dim)


def _bounce_chain(ox, oy, oz, dx, dy, dz, trace, shadow_test, dl_vals,
                  pl_vals, bounce_limit: int, specular: bool,
                  energy_subtract: bool, shade: bool = True):
    """The bounce loop (project_scene, TerminalRayTracer.c:1012-1057) of
    the JAX kernel's ``_bounce_chain`` (render_pallas.py:718).
    ``trace(o, d)`` is the nearest-hit trace (a ``_TraceOut``) and
    ``shadow_test(p)`` returns the ``blocked_by`` test of ``_apply_lighting``
    for hit points p. Aliveness lives in ``contrib``: a miss records its
    weight in sky_w and zeroes contrib; o/d freeze on the death iteration,
    so the final d is the sky direction; counts pack bounces | hits<<5 per
    ray. Each bounce computes on the live rays only; a dead ray's state
    does not change, so this equals the JAX kernel's masked loop.
    ``shade=False`` skips the lighting and its shadow rays (pr, pg, pb stay
    0): lighting feeds none of the other outputs, so they equal the shaded
    chain's bit for bit (render_pallas.py:725-729)."""
    zero = torch.zeros_like(dx)
    pr, pg, pb = zero, zero, zero
    contrib = torch.ones_like(dx)
    total = zero
    sky_w = zero
    count = torch.zeros_like(dx, dtype=torch.int32)

    for _ in range(bounce_limit):
        live = torch.nonzero(contrib > constants.CONTRIBUTION_EPS)[:, 0]
        if live.numel() == 0:
            break
        at = lambda *vs: [v[live] for v in vs]  # noqa: E731
        lox, loy, loz, ldx, ldy, ldz, lcon = at(ox, oy, oz, dx, dy, dz,
                                                 contrib)
        hit = trace(lox, loy, loz, ldx, ldy, ldz)
        if shade:
            lr, lg, lb = _apply_lighting(
                hit.px, hit.py, hit.pz, hit.nx, hit.ny, hit.nz,
                hit.cr, hit.cg, hit.cb, dl_vals, pl_vals,
                shadow_test(hit.px, hit.py, hit.pz),
                view=(-ldx, -ldy, -ldz) if specular else None,
                mspec=hit.spec if specular else None,
            )
            if energy_subtract:
                hw = torch.where(hit.is_hit, lcon * (1.0 - hit.refl), 0.0)
            else:
                hw = torch.where(hit.is_hit, lcon, 0.0)
            lpr, lpg, lpb = at(pr, pg, pb)
            pr = pr.index_put((live,), _fma(hw, lr, lpr))
            pg = pg.index_put((live,), _fma(hw, lg, lpg))
            pb = pb.index_put((live,), _fma(hw, lb, lpb))
        total = total.index_put((live,), total[live] + lcon)
        sky_w = sky_w.index_put(
            (live,), torch.where(hit.is_hit, sky_w[live], lcon))
        contrib = contrib.index_put(
            (live,), torch.where(hit.is_hit, lcon * hit.refl, 0.0))

        dn = 2.0 * _dot3(ldx, ldy, ldz, hit.nx, hit.ny, hit.nz)
        rdx, rdy, rdz = _normalize3(_fma(-dn, hit.nx, ldx),
                                    _fma(-dn, hit.ny, ldy),
                                    _fma(-dn, hit.nz, ldz))
        upd = hit.is_hit
        dx = dx.index_put((live,), torch.where(upd, rdx, ldx))
        dy = dy.index_put((live,), torch.where(upd, rdy, ldy))
        dz = dz.index_put((live,), torch.where(upd, rdz, ldz))
        ox = ox.index_put((live,), torch.where(upd, hit.px, lox))
        oy = oy.index_put((live,), torch.where(upd, hit.py, loy))
        oz = oz.index_put((live,), torch.where(upd, hit.pz, loz))
        count = count.index_put(
            (live,), count[live] + 1 + (upd.to(torch.int32) << 5))
    return pr, pg, pb, total, sky_w, count, dx, dy, dz


def _gen_primary_rays(cam, cfg: RenderConfig, n_rows: Optional[int] = None,
                      n_samples: Optional[int] = None):
    """Ray generation (TerminalRayTracer.c:978-1011) in SAMPLE-MAJOR order,
    ``idx = k * (W*n_rows) + pixel``, with the triangle-wave AA jitter
    (TerminalRayTracer.c:225-228, 992-993). ``n_rows``/``n_samples`` (the
    whole frame by default) cut a band of rows and samples, which start at
    the camera row's row and sample offsets."""
    W, H, N = cfg.width, cfg.height, cfg.rays_per_pixel
    n_pixels = W * (H if n_rows is None else n_rows)
    n_samples = N if n_samples is None else n_samples
    idx = torch.arange(n_pixels * n_samples, device=cam.device)
    f32 = torch.float32
    k = (idx // n_pixels).to(f32) + cam[16]
    pix = idx % n_pixels
    col = (pix % W).to(f32)
    row = (pix // W).to(f32) + cam[15]

    bx0, bx1, bx2, by0, by1, by2, bz0, bz1, bz2 = cam[:9]
    cox, coy, coz, szc, sw, sh = cam[9:15]
    w_t, h_t, n_t = (scalar_like(v, cam) for v in (W, H, N))
    pixel_w = sw / w_t
    pixel_h = sh / h_t

    pi = scalar_like(constants.PI, cam)
    two_pi = scalar_like(2.0 * constants.PI, cam)

    def tri(t):
        # floor-mod, as jnp.mod (render_pallas.py:836-840)
        m = torch.remainder(t, two_pi)
        return torch.where(m < pi, m / pi, 2.0 - m / pi)

    jit_x = tri(2.0 * constants.PI * k / n_t) / 2.0 * pixel_w
    jit_y = tri(constants.PI * k / n_t) / 2.0 * pixel_h
    sxv = (col / w_t) * sw - sw / 2.0 + jit_x
    syv = -((row / h_t) * sh - sh / 2.0) + jit_y

    # reference quirk: direction = screen offset in basis - camera ORIGIN
    # (TerminalRayTracer.c:1005)
    dx, dy, dz = _normalize3(
        sxv * bx0 + syv * by0 + szc * bz0 - cox,
        sxv * bx1 + syv * by1 + szc * bz1 - coy,
        sxv * bx2 + syv * by2 + szc * bz2 - coz,
    )
    return (cox.expand_as(dx), coy.expand_as(dx), coz.expand_as(dx),
            dx, dy, dz)


def _tuples(flat: torch.Tensor, width: int) -> list:
    return [tuple(flat[i * width + j] for j in range(width))
            for i in range(flat.numel() // width)]


def _finish_frame(pr, pg, pb, total, sky_w, count, dx, dy, dz, scene,
                  cfg: RenderConfig, n_rows: int, n_samples: int,
                  scale: float, n_lights: int):
    """The end of a frame after the bounce chain: the procedural sky
    (nearest or bilinear) at the final direction, the contribution-total
    normalization, the in-order sum of each pixel's samples times
    ``scale``, and the trace count (bounces + hits x n_lights). Returns
    ((n_rows, W) Vec3, count)."""
    skr, skg, skb = sky_color(dx, dy, dz, scene.skybox, cfg.skybox_bilinear)
    # the oracle's fold, uncontracted (ttrt/render/integrator.py:221-228)
    pr = pr + sky_w * skr
    pg = pg + sky_w * skg
    pb = pb + sky_w * skb
    if cfg.energy_model == "subtract":
        inv_total = 1.0  # subtract-model weights partition unity
    else:
        inv_total = 1.0 / torch.where(total > 0.0, total, 1.0)

    def avg(c):
        # sample-major: sum the samples of each pixel in order, as the
        # kernel does (a library reduction may pair them differently), then
        # scale
        c = (c * inv_total).reshape(n_samples, n_rows, cfg.width)
        acc = c[0]
        for k in range(1, n_samples):
            acc = acc + c[k]
        return acc * scale

    traces = (count & 0x1F) + ((count >> 5) & 0x1F) * n_lights
    return (Vec3(avg(pr), avg(pg), avg(pb)),
            traces.sum(dtype=torch.int64))


class Band(NamedTuple):
    """Rows [row_offset, row_offset + n_rows) and AA samples
    [sample_offset, sample_offset + n_samples) of a W x H x N frame, and
    the reduction of each pixel's samples: ``'avg'`` scales their sum by
    float32(1/N), the frame's N, ``'sum'`` leaves it
    (``render_band_pallas``, render_pallas.py:1357-1402)."""

    row_offset: int
    n_rows: int
    sample_offset: int
    n_samples: int
    reduce: str = "avg"

    @staticmethod
    def whole(cfg: RenderConfig) -> "Band":
        return Band(0, cfg.height, 0, cfg.rays_per_pixel)

    @staticmethod
    def of(cfg: RenderConfig, row_offset: int = 0,
           n_rows: Optional[int] = None, sample_offset: int = 0,
           n_samples: Optional[int] = None, reduce: str = "avg") -> "Band":
        """The band, checked against the frame: raises ValueError when it
        does not lie inside it or ``reduce`` is unknown."""
        H, N = cfg.height, cfg.rays_per_pixel
        n_rows = H - row_offset if n_rows is None else n_rows
        n_samples = N - sample_offset if n_samples is None else n_samples
        if reduce not in ("avg", "sum"):
            raise ValueError(f"reduce must be 'avg' or 'sum', got {reduce!r}")
        if not (0 <= row_offset and 1 <= n_rows and row_offset + n_rows <= H
                and 0 <= sample_offset and 1 <= n_samples
                and sample_offset + n_samples <= N):
            raise ValueError(
                f"band rows {row_offset}+{n_rows}, samples "
                f"{sample_offset}+{n_samples} outside the {H}-row, "
                f"{N}-sample frame")
        return Band(row_offset, n_rows, sample_offset, n_samples, reduce)

    def scale(self, cfg: RenderConfig) -> float:
        return 1.0 / cfg.rays_per_pixel if self.reduce == "avg" else 1.0


def _demo_chain(scene: Scene, cfg: RenderConfig, shade: bool = True,
                band: Optional[Band] = None):
    """The rays of the demo frame, or of its ``band``, through
    ``_bounce_chain``, sample-major: returns its outputs and the scene's
    light count."""
    band = Band.whole(cfg) if band is None else band
    packed = pack_scene(scene, torch.float32, band.row_offset,
                        band.sample_offset)
    sph_vals = _tuples(packed.spheres, SPHERE_FLOATS)
    plane_vals = tuple(packed.plane[i] for i in range(PLANE_FLOATS))
    dl_vals = _tuples(packed.dlights, DLIGHT_FLOATS)
    pl_vals = _tuples(packed.plights, PLIGHT_FLOATS)

    def trace(ox, oy, oz, dx, dy, dz):
        return _trace(ox, oy, oz, dx, dy, dz, sph_vals, plane_vals,
                      cfg.specular)

    def shadow_test(px, py, pz):
        oc_terms = _shadow_oc_terms(px, py, pz, sph_vals)
        return lambda lx, ly, lz, tmax: _shadow_any_hit(
            px, py, pz, lx, ly, lz, tmax, oc_terms, plane_vals)

    ox, oy, oz, dx, dy, dz = _gen_primary_rays(packed.cam, cfg, band.n_rows,
                                               band.n_samples)
    chain = _bounce_chain(
        ox, oy, oz, dx, dy, dz, trace, shadow_test, dl_vals, pl_vals,
        cfg.bounce_limit, cfg.specular, cfg.energy_model == "subtract",
        shade)
    return chain, len(dl_vals) + len(pl_vals)


def _demo_frame(scene: Scene, cfg: RenderConfig,
                band: Optional[Band] = None):
    """The demo frame, or its ``band``, in plain PyTorch: the (n_rows, W)
    framebuffer, its trace count and the per-ray packed counts (bounces |
    hits << 5)."""
    band = Band.whole(cfg) if band is None else band
    chain, n_lights = _demo_chain(scene, cfg, band=band)
    fb, traces = _finish_frame(*chain, scene, cfg, band.n_rows,
                               band.n_samples, band.scale(cfg), n_lights)
    return fb, traces, chain[5]


def render_band_plain(scene: Scene, cfg: RenderConfig, row_offset: int = 0,
                      n_rows: Optional[int] = None, *, sample_offset: int = 0,
                      n_samples: Optional[int] = None, reduce: str = "avg",
                      count_rays: bool = True
                      ) -> Tuple[Vec3, Optional[torch.Tensor]]:
    """The kernel's math in plain PyTorch on whole ray batches, for a band
    of the frame (``Band``; the whole frame by default): returns the
    (n_rows, W) framebuffer and the band's trace count (bounces + hits x
    n_lights, render_pallas.py:1050-1057), or None for the count when
    ``count_rays`` is False."""
    check_supported(scene, cfg)
    band = Band.of(cfg, row_offset, n_rows, sample_offset, n_samples, reduce)
    render_band_plain.launches += 1
    fb, traces, _ = _demo_frame(scene, cfg, band)
    return fb, traces if count_rays else None


render_band_plain.launches = 0


def render_frame_plain(scene: Scene, cfg: RenderConfig, *,
                       count_rays: bool = True
                       ) -> Tuple[Vec3, Optional[torch.Tensor]]:
    """The whole-frame band of ``render_band_plain``: the (H, W) sample
    average and its trace count."""
    check_supported(scene, cfg)
    render_frame_plain.launches += 1
    fb, traces, _ = _demo_frame(scene, cfg)
    return fb, traces if count_rays else None


render_frame_plain.launches = 0


def traces_from_pixel_sums(sums: torch.Tensor, n_lights: int
                           ) -> torch.Tensor:
    """The frame's trace count from per-pixel 16|16 sums (bounces | hits
    << 16, render_pallas.py:1101-1107): bounces + hits x n_lights. The
    int32 sums set bit 31 once a pixel's hits reach 0x8000, so the hit
    field is masked after the shift, as JAX masks it (:1104)."""
    sums = sums.to(torch.int64)
    return ((sums & 0xFFFF) + ((sums >> 16) & 0xFFFF) * n_lights).sum()


def render_frame_pixel_rate_plain(scene: Scene, cfg: RenderConfig
                                  ) -> Tuple[Vec3, torch.Tensor]:
    """What ``_render_rays_pallas(..., accumulate=True)`` computes
    (render_pallas.py:1059-1107), in plain PyTorch: the per-pixel sample
    average (each sample finished, the samples summed in order from zero,
    times float32(1/N): ``render_frame_plain``'s frame, bit for bit) and
    the trace count decoded from each pixel's sums of the per-sample
    fields repacked into 16|16 (:711-715)."""
    check_pixel_rate(scene, cfg)
    render_frame_pixel_rate_plain.launches += 1
    fb, _, count = _demo_frame(scene, cfg)
    fields = ((count & 0x1F) | (((count >> 5) & 0x1F) << 16)).reshape(
        cfg.rays_per_pixel, cfg.height, cfg.width)
    sums = fields[0]
    for k in range(1, cfg.rays_per_pixel):
        sums = sums + fields[k]
    n_lights = scene.directional_lights.count + scene.point_lights.count
    return fb, traces_from_pixel_sums(sums, n_lights)


render_frame_pixel_rate_plain.launches = 0


def sky_weights_plain(scene: Scene, cfg: RenderConfig) -> torch.Tensor:
    """The per-ray sky weight of the bounce chain with no lighting and no
    shadow rays (``_sky_weight_kernel``, render_pallas.py:860-891), as an
    (N, H, W) float32 tensor, sample-major as the JAX rays: bit for bit the
    ``sky_w`` of the shaded chain."""
    check_supported(scene, cfg)
    sky_weights_plain.launches += 1
    chain, _ = _demo_chain(scene, cfg, shade=False)
    return chain[4].reshape(cfg.rays_per_pixel, cfg.height, cfg.width)


sky_weights_plain.launches = 0


# ---------------------------------------------------------------------------
# The CUDA kernels' wrappers
# ---------------------------------------------------------------------------


def _scene_buffer(scene: Scene, name: str, row_offset: int = 0,
                  sample_offset: int = 0):
    """The packed scene, the camera row carrying a band's offsets, as one
    contiguous float32 CUDA buffer: (buf, n_sph, n_dl, n_pl). The kernels
    take any sphere and light count. Raises on CPU tensors."""
    packed = pack_scene(scene, torch.float32, row_offset, sample_offset)
    buf = torch.cat(list(packed)).contiguous()
    if buf.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {buf.device}")
    n_sph = scene.spheres.count
    n_dl = scene.directional_lights.count
    n_pl = scene.point_lights.count
    expected = (CAM_FLOATS + SPHERE_FLOATS * n_sph + PLANE_FLOATS
                + DLIGHT_FLOATS * n_dl + PLIGHT_FLOATS * n_pl)
    if buf.dtype != torch.float32 or buf.numel() != expected:
        raise ValueError(f"packed scene must be {expected} float32 values, "
                         f"got {buf.numel()} {buf.dtype}")
    return buf, n_sph, n_dl, n_pl


def sky_table(skybox, device) -> torch.Tensor:
    """The cubemap's packed texels as the kernels read them: a flat,
    contiguous int32 tensor on ``device`` (read only for an image sky)."""
    flat = skybox.packed.reshape(-1)
    if flat.dtype != torch.int32 or flat.device != device:
        raise ValueError("the sky's texels must be int32 on "
                         f"{device}, got {flat.dtype} on {flat.device}")
    return flat.contiguous()


def _launch_render(scene: Scene, cfg: RenderConfig, name: str,
                   pixel_rate: bool, band: Optional[Band] = None):
    """Launch ``render_kernel`` (csrc/render.cu) on ``band`` (the whole
    frame by default): returns the (3, n_rows, W) band and the per-pixel
    counts (trace counts, or with ``pixel_rate`` the 16|16 sums)."""
    from ttrt_torch.kernels import build

    band = Band.whole(cfg) if band is None else band
    buf, n_sph, n_dl, n_pl = _scene_buffer(scene, name, band.row_offset,
                                           band.sample_offset)
    texels = sky_table(scene.skybox, buf.device)
    H, W, N = cfg.height, cfg.width, cfg.rays_per_pixel
    out = torch.empty((3, band.n_rows, W), dtype=torch.float32,
                      device=buf.device)
    counts = torch.empty((band.n_rows, W), dtype=torch.int32,
                         device=buf.device)
    stream = torch.cuda.current_stream(buf.device).cuda_stream
    rc = build.load().ttrt_render(
        buf.data_ptr(), n_sph, n_dl, n_pl, W, H, N, band.n_rows,
        band.n_samples, cfg.bounce_limit, int(cfg.specular),
        int(cfg.energy_model == "subtract"), sky_kind(scene.skybox),
        scene.skybox.dim, int(cfg.skybox_bilinear), texels.data_ptr(),
        band.scale(cfg), int(pixel_rate), out.data_ptr(), counts.data_ptr(),
        stream,
    )
    if rc != 0:
        raise RuntimeError(f"render kernel launch failed: CUDA error {rc}")
    return out, counts


def render_band_cuda(scene: Scene, cfg: RenderConfig, row_offset: int = 0,
                     n_rows: Optional[int] = None, *, sample_offset: int = 0,
                     n_samples: Optional[int] = None, reduce: str = "avg",
                     count_rays: bool = True
                     ) -> Tuple[Vec3, Optional[torch.Tensor]]:
    """Render a band of the frame (``Band``) with the CUDA kernel
    (csrc/render.cu): one thread per (pixel, sample) of the band, a
    pixel's first thread writing its sample average or sum and its trace
    count (``render_layout`` gives the launch shape). Raises on anything
    the kernel does not take, CPU tensors included."""
    check_supported(scene, cfg)
    band = Band.of(cfg, row_offset, n_rows, sample_offset, n_samples, reduce)
    out, counts = _launch_render(scene, cfg, "render_band_cuda", False, band)
    render_band_cuda.launches += 1
    fb = Vec3(out[0], out[1], out[2])
    return fb, counts.sum(dtype=torch.int64) if count_rays else None


render_band_cuda.launches = 0


def render_frame_cuda(scene: Scene, cfg: RenderConfig, *,
                      count_rays: bool = True
                      ) -> Tuple[Vec3, Optional[torch.Tensor]]:
    """Render one frame with the CUDA kernel (csrc/render.cu), the
    whole-frame band of ``render_band_cuda``: the (3, H, W) sample average
    and each pixel's trace count. Raises on anything the kernel does not
    take, CPU tensors included; the count is summed only when
    ``count_rays`` is set."""
    check_supported(scene, cfg)
    out, counts = _launch_render(scene, cfg, "render_frame_cuda", False)
    render_frame_cuda.launches += 1
    fb = Vec3(out[0], out[1], out[2])
    return fb, counts.sum(dtype=torch.int64) if count_rays else None


render_frame_cuda.launches = 0


def render_frame_pixel_rate_cuda(scene: Scene, cfg: RenderConfig
                                 ) -> Tuple[Vec3, torch.Tensor]:
    """``render_frame_pixel_rate`` with the CUDA kernel
    (``render_kernel<true>``): the frame, and the trace count decoded from
    the per-pixel 16|16 sums. Raises on CPU tensors."""
    check_pixel_rate(scene, cfg)
    out, sums = _launch_render(scene, cfg, "render_frame_pixel_rate_cuda",
                               True)
    render_frame_pixel_rate_cuda.launches += 1
    n_lights = scene.directional_lights.count + scene.point_lights.count
    return (Vec3(out[0], out[1], out[2]),
            traces_from_pixel_sums(sums, n_lights))


render_frame_pixel_rate_cuda.launches = 0


RENDER_LAYOUT_KEYS = ("sample_threads", "pixels_per_block",
                      "threads_per_block", "blocks", "smem_bytes",
                      "scene_staged", "blocks_per_sm", "sms", "registers",
                      "local_bytes")


def render_layout(scene: Scene, cfg: RenderConfig,
                  n_rows: Optional[int] = None,
                  n_samples: Optional[int] = None,
                  pixel_rate: bool = False) -> dict:
    """The launch shape ``render_band_cuda`` (or with ``pixel_rate`` the
    pixel-rate frame) takes for a band of ``scene``
    (``ttrt_render_layout``): the sample threads of a pixel, pixels,
    threads and dynamic shared bytes of a block, the blocks, whether the
    scene is staged in shared memory, the blocks an SM holds and the SMs
    (hence ``waves``), and the kernel's registers and local (spill) bytes
    a thread. Needs a CUDA device."""
    from ttrt_torch.kernels import build

    return build.layout(
        "ttrt_render_layout", RENDER_LAYOUT_KEYS, scene.spheres.count,
        scene.directional_lights.count, scene.point_lights.count, cfg.width,
        cfg.height if n_rows is None else n_rows,
        cfg.rays_per_pixel if n_samples is None else n_samples,
        int(pixel_rate))


def sky_weights_layout(scene: Scene, cfg: RenderConfig) -> dict:
    """The launch shape ``sky_weights_cuda`` takes
    (``ttrt_sky_weights_layout``), with ``render_layout``'s keys: one
    thread a ray (``sample_threads`` 1, ``pixels_per_block`` the rays of
    a block). Needs a CUDA device."""
    from ttrt_torch.kernels import build

    return build.layout(
        "ttrt_sky_weights_layout", RENDER_LAYOUT_KEYS, scene.spheres.count,
        scene.directional_lights.count, scene.point_lights.count, cfg.width,
        cfg.height, cfg.rays_per_pixel)


def sky_weights_cuda(scene: Scene, cfg: RenderConfig) -> torch.Tensor:
    """``sky_weights`` with the CUDA kernel (``sky_weight_kernel``): one
    thread per ray, a pixel's samples on neighbouring threads, writes its
    sky weight (``sky_weights_layout`` gives the launch shape). Raises on
    CPU tensors."""
    from ttrt_torch.kernels import build

    check_supported(scene, cfg)
    buf, n_sph, n_dl, n_pl = _scene_buffer(scene, "sky_weights_cuda")
    H, W, N = cfg.height, cfg.width, cfg.rays_per_pixel
    out = torch.empty((N, H, W), dtype=torch.float32, device=buf.device)
    stream = torch.cuda.current_stream(buf.device).cuda_stream
    rc = build.load().ttrt_sky_weights(
        buf.data_ptr(), n_sph, n_dl, n_pl, W, H, N, cfg.bounce_limit,
        out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(
            f"sky-weight kernel launch failed: CUDA error {rc}")
    sky_weights_cuda.launches += 1
    return out


sky_weights_cuda.launches = 0


def _on_cpu(scene) -> bool:
    return scene.spheres.radius.device.type == "cpu"


def render_band(scene: Scene, cfg: RenderConfig, row_offset: int = 0,
                n_rows: Optional[int] = None, **kw
                ) -> Tuple[Vec3, Optional[torch.Tensor]]:
    """Render a band of the frame (``Band``) on the device that holds the
    scene: the plain version for CPU tensors, the CUDA kernel for CUDA
    tensors."""
    fn = render_band_plain if _on_cpu(scene) else render_band_cuda
    return fn(scene, cfg, row_offset, n_rows, **kw)


def render_frame(scene: Scene, cfg: RenderConfig, *,
                 count_rays: bool = True
                 ) -> Tuple[Vec3, Optional[torch.Tensor]]:
    """Render one frame on the device that holds the scene: the plain
    version for CPU tensors, the CUDA kernel for CUDA tensors."""
    fn = render_frame_plain if _on_cpu(scene) else render_frame_cuda
    return fn(scene, cfg, count_rays=count_rays)


def render_frame_pixel_rate(scene: Scene, cfg: RenderConfig
                            ) -> Tuple[Vec3, torch.Tensor]:
    """The pixel-rate layout of the frame (``_render_kernel_acc``) on the
    device that holds the scene: the (H, W) framebuffer, equal to
    ``render_frame``'s, and its trace count."""
    fn = (render_frame_pixel_rate_plain if _on_cpu(scene)
          else render_frame_pixel_rate_cuda)
    return fn(scene, cfg)


def sky_weights(scene: Scene, cfg: RenderConfig) -> torch.Tensor:
    """The (N, H, W) per-ray sky weights (``_sky_weight_kernel``) on the
    device that holds the scene."""
    return (sky_weights_plain if _on_cpu(scene) else sky_weights_cuda)(
        scene, cfg)
