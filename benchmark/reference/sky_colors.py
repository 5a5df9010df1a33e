"""The 'colors' sky (the source's ``skybox/colors`` faces: +X red, -X
cyan, +Y green, -Y magenta, +Z blue, -Z yellow, each one solid color).

A sky is found by its name: ``sky_<name>.py`` defines ``build(config, *,
device)``, which returns the sky's two lookups:

- ``gather(d)``: the integrator's, the nearest texel along the direction
  batch ``d`` (a ``Vec3``), through the shared cubemap lookup;
- ``by_face(dx, dy, dz)``: the path tracer's plain version's, [r, g, b].
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import sky
from benchmark.reference.vec import Vec3, normalize3

FACE_COLORS = np.array([[255, 0, 0], [0, 255, 255], [0, 255, 0],
                        [255, 0, 255], [0, 0, 255], [255, 255, 0]], np.int32)


def table(device) -> torch.Tensor:
    """The (6 * DIM * DIM,) packed 0x00RRGGBB texels."""
    c = FACE_COLORS
    packed = (c[:, 0] << 16) | (c[:, 1] << 8) | c[:, 2]
    return torch.as_tensor(np.repeat(packed, sky.DIM * sky.DIM),
                           device=device)


def by_face(dx, dy, dz):
    """The sky along (dx, dy, dz): its faces are solid, so the texel is
    the face's color (the first strict maximum of dir . axis)."""
    ddx, ddy, ddz = normalize3(dx, dy, dz)
    best, face = ddx, torch.zeros_like(dx, dtype=torch.int32)
    for f, (axis, sign) in enumerate(((0, -1.0), (1, 1.0), (1, -1.0),
                                      (2, 1.0), (2, -1.0)), start=1):
        d = (ddx, ddy, ddz)[axis] * sign
        # the scan's dot with a unit axis: one product and two exact zeros
        m = d > best
        best = torch.where(m, d, best)
        face = torch.where(m, f, face)
    out = []
    for ch in range(3):
        col = torch.full_like(dx, float(FACE_COLORS[0, ch] // 255))
        for f in range(1, 6):
            col = torch.where(face == f, float(FACE_COLORS[f, ch] // 255),
                              col)
        out.append(col)
    return out


class ColorsSky:
    def __init__(self, device):
        self.table = table(device)

    def gather(self, d: Vec3) -> Vec3:
        return sky.sample(self.table, d)

    by_face = staticmethod(by_face)


def build(config: dict, *, device) -> ColorsSky:
    """The sky as ``config`` serves it: nearest (its faces are solid; the
    reference has no bilinear lookup)."""
    if config["bilinear"]:
        raise ValueError("the 'colors' reference is nearest")
    return ColorsSky(device)
