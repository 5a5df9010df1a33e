"""Cubemap skybox sampling (port of ``ttrt.render.skybox``): the axis
tables of get_skybox_color (TerminalRayTracer.c:697-789) and the plain
gathers of the eager integrator.

The face is the argmax over the six cube axes of dot(dir, axis); (u, v) are
the orthogonal component dotted with the axes (face+2)%6 and (face+4)%6,
then the reference's per-face fixups (TerminalRayTracer.c:729-761: odd faces
mirror u; faces 0/1 rotate -90deg; 2/3 rotate +90deg; 4 rotates 180deg).
Those fixups are sign flips and swaps, folded exactly into the (6, 3)
tables U_AXIS and V_AXIS. The render kernel (kernels/csrc/render.cu) holds
the same tables as literals; a CPU test checks that they agree.
"""

from __future__ import annotations

import numpy as np
import torch

from ttrt_torch.vec import Vec3

# Cube axes in face order +X,-X,+Y,-Y,+Z,-Z (TerminalRayTracer.c:137-143).
CUBEMAP_AXES = np.array(
    [
        [1.0, 0.0, 0.0],
        [-1.0, 0.0, 0.0],
        [0.0, 1.0, 0.0],
        [0.0, -1.0, 0.0],
        [0.0, 0.0, 1.0],
        [0.0, 0.0, -1.0],
    ]
)


def _build_uv_tables():
    """Fold the (face+2)%6 / (face+4)%6 axis picks and the per-face fixups
    (TerminalRayTracer.c:726-761) into (6,3) U/V axis tables."""
    u_axis = np.zeros((6, 3))
    v_axis = np.zeros((6, 3))
    for f in range(6):
        a2 = CUBEMAP_AXES[(f + 2) % 6]
        a4 = CUBEMAP_AXES[(f + 4) % 6]
        mir = np.diag([-1.0, 1.0]) if f % 2 == 1 else np.eye(2)
        if f in (0, 1):  # rotate -90: (u,v) -> (v,-u)
            rot = np.array([[0.0, 1.0], [-1.0, 0.0]])
        elif f in (2, 3):  # rotate +90: (u,v) -> (-v,u)
            rot = np.array([[0.0, -1.0], [1.0, 0.0]])
        elif f == 4:  # rotate 180
            rot = -np.eye(2)
        else:
            rot = np.eye(2)
        t = rot @ mir
        u_axis[f] = t[0, 0] * a2 + t[0, 1] * a4
        v_axis[f] = t[1, 0] * a2 + t[1, 1] * a4
    return u_axis, v_axis


U_AXIS, V_AXIS = _build_uv_tables()


def skybox_uv(d):
    """Direction batch -> (face, u, v) with u, v clamped to [-0.5, 0.5]
    (TerminalRayTracer.c:697-776): the face is the first argmax of
    dot(dir, axis); the orthogonal component is dotted with the folded
    U/V axis tables."""
    dirn = d.normalize()  # guarded normalize (TerminalRayTracer.c:702)
    dtype, device = dirn.x.dtype, dirn.x.device
    axes = torch.as_tensor(CUBEMAP_AXES, dtype=dtype, device=device)
    dots = torch.stack([axes[f, 0] * dirn.x + axes[f, 1] * dirn.y
                        + axes[f, 2] * dirn.z for f in range(6)])
    best_t, face = torch.max(dots, dim=0)  # first maximum, as argmax
    inv = 1.0 / best_t
    sx, sy, sz = dirn.x * inv, dirn.y * inv, dirn.z * inv
    ax, ay, az = (axes[:, i][face] for i in range(3))
    # the C recomputes t = dot(scaled, axis) (TerminalRayTracer.c:720)
    t2 = sx * ax + sy * ay + sz * az
    ox = (sx - t2 * ax) * 0.5
    oy = (sy - t2 * ay) * 0.5
    oz = (sz - t2 * az) * 0.5
    uax = torch.as_tensor(U_AXIS, dtype=dtype, device=device)
    vax = torch.as_tensor(V_AXIS, dtype=dtype, device=device)
    u = ox * uax[:, 0][face] + oy * uax[:, 1][face] + oz * uax[:, 2][face]
    v = ox * vax[:, 0][face] + oy * vax[:, 1][face] + oz * vax[:, 2][face]
    return (face.to(torch.int32), torch.clamp(u, -0.5, 0.5),
            torch.clamp(v, -0.5, 0.5))


def _unpack(texels: torch.Tensor, dtype):
    """0x00RRGGBB -> float [0, 1] channels: a true division by 255, as the
    reference's texel/255.0 (TerminalRayTracer.c:866)."""
    c255 = torch.full((), 255.0, dtype=dtype, device=texels.device)
    return Vec3(((texels >> 16) & 0xFF).to(dtype) / c255,
                ((texels >> 8) & 0xFF).to(dtype) / c255,
                (texels & 0xFF).to(dtype) / c255)


def sample_skybox(skybox, d, *, bilinear: bool = False):
    """Cubemap color along direction batch ``d`` as a plain gather:
    nearest texel by int truncation (TerminalRayTracer.c:778-788), or the
    bilinear filter of the reference's roadmap item
    (TerminalRayTracer.c:23) with texel centers at (i + 0.5)/dim."""
    dtype = d.x.dtype
    face, u, v = skybox_uv(d)
    dim = skybox.dim
    flat = skybox.packed.reshape(-1).to(d.x.device)
    if not bilinear:
        ui = torch.clamp_max(((u + 0.5) * dim).to(torch.int32), dim - 1)
        vi = torch.clamp_max(((v + 0.5) * dim).to(torch.int32), dim - 1)
        return _unpack(flat[(face * (dim * dim) + vi * dim + ui).long()],
                       dtype)
    fu = (u + 0.5) * dim - 0.5
    fv = (v + 0.5) * dim - 0.5
    u0 = torch.clamp(torch.floor(fu).to(torch.int32), 0, dim - 1)
    v0 = torch.clamp(torch.floor(fv).to(torch.int32), 0, dim - 1)
    u1 = torch.clamp_max(u0 + 1, dim - 1)
    v1 = torch.clamp_max(v0 + 1, dim - 1)
    wu = torch.clamp(fu - u0.to(dtype), 0.0, 1.0)
    wv = torch.clamp(fv - v0.to(dtype), 0.0, 1.0)
    base = face * (dim * dim)

    def fetch(vi, ui):
        return _unpack(flat[(base + vi * dim + ui).long()], dtype)

    c00, c01 = fetch(v0, u0), fetch(v0, u1)
    c10, c11 = fetch(v1, u0), fetch(v1, u1)
    top = c00 * (1.0 - wu) + c01 * wu
    bot = c10 * (1.0 - wu) + c11 * wu
    return top * (1.0 - wv) + bot * wv
