"""Cubemap axis tables of get_skybox_color (TerminalRayTracer.c:697-789),
port of the constant part of ``ttrt.render.skybox``.

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
