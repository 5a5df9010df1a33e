"""The demo-scene render kernel: scene packing, the CUDA wrapper, and its
plain PyTorch version (port of ``ttrt/kernels/render_pallas.py``).

``render_frame`` dispatches on the device of the scene's tensors: CPU
tensors go through ``render_frame_plain``; CUDA tensors go through
``render_frame_cuda``, which launches the hand-written kernel in
``csrc/render.cu`` or raises. There is no fallback from one to the other.

``render_frame_plain`` mirrors the kernel's math op for op, as the JAX
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
that the knife-edge classes cover.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from ttrt_torch.config import ConfigError, RenderConfig, constants
from ttrt_torch.render.skybox import CUBEMAP_AXES, U_AXIS, V_AXIS
from ttrt_torch.scene import Scene
from ttrt_torch.vec import Vec3, scalar_like, sqrt_rn

CAM_FLOATS = 17
SPHERE_FLOATS = 9
PLANE_FLOATS = 16
DLIGHT_FLOATS = 6
PLIGHT_FLOATS = 7

# procedural skies the kernel evaluates in place of a texel fetch
SKY_KINDS = {"colors": 0, "uv_checker": 1}

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


def check_supported(scene: Scene, cfg: RenderConfig) -> None:
    """The gates of ``render_frame_pallas`` (render_pallas.py:1292-1325)
    that this slice keeps: float32, a procedural sky, nearest texels,
    bounce_limit <= 16 (the per-ray trace counts pack 5-bit fields)."""
    if cfg.dtype != torch.float32:
        raise ConfigError("the render kernel is float32-only")
    if cfg.skybox_bilinear:
        raise ConfigError("bilinear skybox filtering is not yet ported")
    if scene.skybox.procedural not in SKY_KINDS:
        raise ConfigError(
            "image cubemaps are not yet ported; use a procedural sky "
            f"({', '.join(SKY_KINDS)})"
        )
    if cfg.bounce_limit > 16:
        raise ConfigError("the render kernel supports bounce_limit <= 16")


# ---------------------------------------------------------------------------
# The plain version: the kernel's math on whole ray batches
# ---------------------------------------------------------------------------


def _fma(a, b, c):
    """``fmaf(a, b, c)``: a*b + c rounded once to float32. Emulated in
    float64, where the product of two float32 values is exact; the sum then
    rounds twice, which differs from one rounding only on exact ties."""
    f64 = lambda v: v.double() if isinstance(v, torch.Tensor) else v  # noqa: E731
    return (f64(a) * f64(b) + f64(c)).float()


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
                    sph_vals, plane_vals, view=None, mspec=None):
    """Diffuse shading with any-hit shadow traces (apply_lighting,
    TerminalRayTracer.c:894-963); returns lit (r, g, b) clamped to [0, 1].
    ``view``/``mspec`` switch on the Blinn-Phong specular extension
    (TerminalRayTracer.c:913-916, 947-950)."""
    outr = torch.zeros_like(px)
    outg = torch.zeros_like(px)
    outb = torch.zeros_like(px)
    oc_terms = _shadow_oc_terms(px, py, pz, sph_vals)

    for (lx, ly, lz, lcr, lcg, lcb) in dl_vals:
        blocked = _shadow_any_hit(px, py, pz, lx, ly, lz, None, oc_terms,
                                  plane_vals)
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
        blocked = _shadow_any_hit(px, py, pz, ldx, ldy, ldz, tmax, oc_terms,
                                  plane_vals)
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


def _sky_face_uv(dx, dy, dz, dim: int):
    """(face, ui, vi) nearest texel of get_skybox_color
    (TerminalRayTracer.c:700-788): strict-greater face scan, the per-face
    uv fixups folded into U_AXIS/V_AXIS, clamp to [-0.5, 0.5], and the
    reference's int truncation clamped to dim-1."""
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
    u = torch.clamp(u, -0.5, 0.5)
    v = torch.clamp(v, -0.5, 0.5)
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


def _sky_color_procedural(dx, dy, dz, dim: int, kind: str):
    face, ui, vi = _sky_face_uv(dx, dy, dz, dim)
    return _procedural_texel(face, ui, vi, dim, kind)


def _bounce_chain(ox, oy, oz, dx, dy, dz, sph_vals, plane_vals, dl_vals,
                  pl_vals, bounce_limit: int, specular: bool,
                  energy_subtract: bool):
    """The masked bounce loop (project_scene, TerminalRayTracer.c:1012-1057)
    of the JAX kernel's ``_bounce_chain`` (render_pallas.py:718).
    Aliveness lives in ``contrib`` (a miss records its weight in sky_w and
    zeroes contrib); o/d freeze on the death iteration, so the final d is
    the sky direction; counts pack bounces | hits<<5 per ray."""
    zero = torch.zeros_like(dx)
    pr, pg, pb = zero, zero, zero
    contrib = torch.ones_like(dx)
    total = zero
    sky_w = zero
    count = torch.zeros_like(dx, dtype=torch.int32)

    for _ in range(bounce_limit):
        alive = contrib > constants.CONTRIBUTION_EPS
        hit = _trace(ox, oy, oz, dx, dy, dz, sph_vals, plane_vals, specular)
        miss_now = alive & ~hit.is_hit
        upd = alive & hit.is_hit

        aw = torch.where(alive, contrib, 0.0)
        lr, lg, lb = _apply_lighting(
            hit.px, hit.py, hit.pz, hit.nx, hit.ny, hit.nz,
            hit.cr, hit.cg, hit.cb, dl_vals, pl_vals, sph_vals, plane_vals,
            view=(-dx, -dy, -dz) if specular else None,
            mspec=hit.spec if specular else None,
        )
        if energy_subtract:
            hw = torch.where(hit.is_hit, aw * (1.0 - hit.refl), 0.0)
        else:
            hw = torch.where(hit.is_hit, aw, 0.0)
        pr = _fma(hw, lr, pr)
        pg = _fma(hw, lg, pg)
        pb = _fma(hw, lb, pb)
        total = total + aw
        sky_w = torch.where(miss_now, contrib, sky_w)
        contrib = torch.where(
            alive, torch.where(upd, contrib * hit.refl, 0.0), contrib)

        dn = 2.0 * _dot3(dx, dy, dz, hit.nx, hit.ny, hit.nz)
        rdx, rdy, rdz = _normalize3(_fma(-dn, hit.nx, dx),
                                    _fma(-dn, hit.ny, dy),
                                    _fma(-dn, hit.nz, dz))
        dx = torch.where(upd, rdx, dx)
        dy = torch.where(upd, rdy, dy)
        dz = torch.where(upd, rdz, dz)
        ox = torch.where(upd, hit.px, ox)
        oy = torch.where(upd, hit.py, oy)
        oz = torch.where(upd, hit.pz, oz)
        count = count + alive.to(torch.int32) + (upd.to(torch.int32) << 5)
    return pr, pg, pb, total, sky_w, count, dx, dy, dz


def _gen_primary_rays(cam, cfg: RenderConfig):
    """Ray generation (TerminalRayTracer.c:978-1011) in SAMPLE-MAJOR order,
    ``idx = k * (W*H) + pixel``, with the triangle-wave AA jitter
    (TerminalRayTracer.c:225-228, 992-993)."""
    W, H, N = cfg.width, cfg.height, cfg.rays_per_pixel
    n_pixels = W * H
    idx = torch.arange(n_pixels * N, device=cam.device)
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


def render_frame_plain(scene: Scene, cfg: RenderConfig, *,
                       count_rays: bool = True
                       ) -> Tuple[Vec3, Optional[torch.Tensor]]:
    """The kernel's math in plain PyTorch on whole ray batches: returns the
    (H, W) framebuffer and the frame's trace count (bounces + hits x
    n_lights, render_pallas.py:1050-1057), or None for the count when
    ``count_rays`` is False."""
    check_supported(scene, cfg)
    render_frame_plain.launches += 1
    packed = pack_scene(scene, torch.float32)
    sph_vals = _tuples(packed.spheres, SPHERE_FLOATS)
    plane_vals = tuple(packed.plane[i] for i in range(PLANE_FLOATS))
    dl_vals = _tuples(packed.dlights, DLIGHT_FLOATS)
    pl_vals = _tuples(packed.plights, PLIGHT_FLOATS)

    ox, oy, oz, dx, dy, dz = _gen_primary_rays(packed.cam, cfg)
    pr, pg, pb, total, sky_w, count, dx, dy, dz = _bounce_chain(
        ox, oy, oz, dx, dy, dz, sph_vals, plane_vals, dl_vals, pl_vals,
        cfg.bounce_limit, cfg.specular, cfg.energy_model == "subtract",
    )
    skr, skg, skb = _sky_color_procedural(dx, dy, dz, scene.skybox.dim,
                                          scene.skybox.procedural)
    pr = pr + sky_w * skr
    pg = pg + sky_w * skg
    pb = pb + sky_w * skb
    if cfg.energy_model == "subtract":
        inv_total = 1.0  # subtract-model weights partition unity
    else:
        inv_total = 1.0 / torch.where(total > 0.0, total, 1.0)

    H, W, N = cfg.height, cfg.width, cfg.rays_per_pixel

    def avg(c):
        # sample-major: sum the N samples of each pixel in order, as the
        # kernel does (a library reduction may pair them differently), then
        # scale by 1/N
        c = (c * inv_total).reshape(N, H, W)
        acc = c[0]
        for k in range(1, N):
            acc = acc + c[k]
        return acc * (1.0 / N)

    fb = Vec3(avg(pr), avg(pg), avg(pb))
    if not count_rays:
        return fb, None
    n_lights = len(dl_vals) + len(pl_vals)
    traces = (count & 0x1F) + ((count >> 5) & 0x1F) * n_lights
    return fb, traces.sum(dtype=torch.int64)


render_frame_plain.launches = 0


# ---------------------------------------------------------------------------
# The CUDA kernel's wrapper
# ---------------------------------------------------------------------------


def render_frame_cuda(scene: Scene, cfg: RenderConfig, *,
                      count_rays: bool = True
                      ) -> Tuple[Vec3, Optional[torch.Tensor]]:
    """Render one frame with the CUDA kernel (csrc/render.cu): one thread
    per pixel writes the (3, H, W) sample average and the pixel's trace
    count. Raises on anything the kernel does not take, CPU tensors
    included; the count is summed only when ``count_rays`` is set."""
    from ttrt_torch.kernels import build

    check_supported(scene, cfg)
    packed = pack_scene(scene, torch.float32)
    buf = torch.cat(list(packed)).contiguous()
    if buf.device.type != "cuda":
        raise ValueError(
            f"render_frame_cuda needs CUDA tensors, got {buf.device}")
    n_sph = scene.spheres.count
    n_dl = scene.directional_lights.count
    n_pl = scene.point_lights.count
    expected = (CAM_FLOATS + SPHERE_FLOATS * n_sph + PLANE_FLOATS
                + DLIGHT_FLOATS * n_dl + PLIGHT_FLOATS * n_pl)
    if buf.dtype != torch.float32 or buf.numel() != expected:
        raise ValueError(f"packed scene must be {expected} float32 values, "
                         f"got {buf.numel()} {buf.dtype}")

    lib = build.load()
    limits = (ctypes.c_int * 3)()
    lib.ttrt_render_limits(limits)
    if n_sph > limits[0] or n_dl > limits[1] or n_pl > limits[2]:
        raise ConfigError(
            f"the render kernel takes at most {limits[0]} spheres, "
            f"{limits[1]} directional and {limits[2]} point lights; got "
            f"{n_sph}, {n_dl}, {n_pl}")

    H, W, N = cfg.height, cfg.width, cfg.rays_per_pixel
    out = torch.empty((3, H, W), dtype=torch.float32, device=buf.device)
    counts = torch.empty((H, W), dtype=torch.int32, device=buf.device)
    stream = torch.cuda.current_stream(buf.device).cuda_stream
    rc = lib.ttrt_render(
        buf.data_ptr(), n_sph, n_dl, n_pl, W, H, N, cfg.bounce_limit,
        int(cfg.specular), int(cfg.energy_model == "subtract"),
        SKY_KINDS[scene.skybox.procedural], scene.skybox.dim,
        out.data_ptr(), counts.data_ptr(), stream,
    )
    if rc != 0:
        raise RuntimeError(f"render kernel launch failed: CUDA error {rc}")
    render_frame_cuda.launches += 1
    fb = Vec3(out[0], out[1], out[2])
    return fb, counts.sum(dtype=torch.int64) if count_rays else None


render_frame_cuda.launches = 0


def render_frame(scene: Scene, cfg: RenderConfig, *,
                 count_rays: bool = True
                 ) -> Tuple[Vec3, Optional[torch.Tensor]]:
    """Render one frame on the device that holds the scene: the plain
    version for CPU tensors, the CUDA kernel for CUDA tensors."""
    if scene.spheres.radius.device.type == "cpu":
        return render_frame_plain(scene, cfg, count_rays=count_rays)
    return render_frame_cuda(scene, cfg, count_rays=count_rays)
