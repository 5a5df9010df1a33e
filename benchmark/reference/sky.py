"""The cubemap lookup the skies share (get_skybox_color,
TerminalRayTracer.c:697-789): the face is the first argmax of dot(dir,
axis), (u, v) the orthogonal component dotted with the face's folded u
and v axes, the texel the int truncation of (u + 0.5) * dim, unpacked
with a true division by 255. Each sky's texels are in a file of its own,
``sky_<name>.py``."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.vec import Vec3

AXES = np.array([[1.0, 0.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
                 [0.0, -1.0, 0.0], [0.0, 0.0, 1.0], [0.0, 0.0, -1.0]])
DIM = 256


def _uv_tables():
    """The axes (face+2)%6 and (face+4)%6 with the per-face fixups
    (TerminalRayTracer.c:726-761: odd faces mirror u; faces 0/1 rotate
    -90 degrees, 2/3 +90, 4 by 180) folded into (6, 3) tables."""
    u_axis, v_axis = np.zeros((6, 3)), np.zeros((6, 3))
    for f in range(6):
        a2, a4 = AXES[(f + 2) % 6], AXES[(f + 4) % 6]
        mir = np.diag([-1.0, 1.0]) if f % 2 == 1 else np.eye(2)
        if f in (0, 1):
            rot = np.array([[0.0, 1.0], [-1.0, 0.0]])
        elif f in (2, 3):
            rot = np.array([[0.0, -1.0], [1.0, 0.0]])
        elif f == 4:
            rot = -np.eye(2)
        else:
            rot = np.eye(2)
        m = rot @ mir
        u_axis[f] = m[0, 0] * a2 + m[0, 1] * a4
        v_axis[f] = m[1, 0] * a2 + m[1, 1] * a4
    return u_axis, v_axis


U_AXIS, V_AXIS = _uv_tables()


def sample(table: torch.Tensor, d: Vec3) -> Vec3:
    """The nearest texel of ``table``, (6 * DIM * DIM,) packed 0x00RRGGBB,
    along the direction batch ``d``."""
    dirn = d.normalize()
    dtype, device = dirn.x.dtype, dirn.x.device
    axes = torch.as_tensor(AXES, dtype=dtype, device=device)
    dots = torch.stack([axes[f, 0] * dirn.x + axes[f, 1] * dirn.y
                        + axes[f, 2] * dirn.z for f in range(6)])
    best, face = torch.max(dots, dim=0)
    inv = 1.0 / best
    sx, sy, sz = dirn.x * inv, dirn.y * inv, dirn.z * inv
    ax, ay, az = (axes[:, i][face] for i in range(3))
    t2 = sx * ax + sy * ay + sz * az
    ox = (sx - t2 * ax) * 0.5
    oy = (sy - t2 * ay) * 0.5
    oz = (sz - t2 * az) * 0.5
    uax = torch.as_tensor(U_AXIS, dtype=dtype, device=device)
    vax = torch.as_tensor(V_AXIS, dtype=dtype, device=device)
    u = ox * uax[:, 0][face] + oy * uax[:, 1][face] + oz * uax[:, 2][face]
    v = ox * vax[:, 0][face] + oy * vax[:, 1][face] + oz * vax[:, 2][face]
    u = torch.clamp(u, -0.5, 0.5)
    v = torch.clamp(v, -0.5, 0.5)
    ui = torch.clamp_max(((u + 0.5) * DIM).to(torch.int32), DIM - 1)
    vi = torch.clamp_max(((v + 0.5) * DIM).to(torch.int32), DIM - 1)
    texel = table[(face.to(torch.int32) * (DIM * DIM) + vi * DIM + ui).long()]
    c255 = torch.full((), 255.0, dtype=dtype, device=device)
    return Vec3(((texel >> 16) & 0xFF).to(dtype) / c255,
                ((texel >> 8) & 0xFF).to(dtype) / c255,
                (texel & 0xFF).to(dtype) / c255)
