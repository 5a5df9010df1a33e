"""The containers the reference's scenes share: spheres, lights and the
per-ray hit record (the source's scene structs, TerminalRayTracer.c:60-208,
as tensors)."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference.vec import Vec3

HIT_NONE = 0
HIT_SPHERE = 1
HIT_GROUND = 2
HIT_TRIANGLE = 3


class Spheres(NamedTuple):
    center: Vec3  # each (N,)
    radius: torch.Tensor
    color: Vec3
    reflectivity: torch.Tensor

    @property
    def count(self) -> int:
        return self.radius.shape[-1]


class Lights(NamedTuple):
    """One directional light and one point light, as the source's demo
    has (TerminalRayTracer.c:1290-1306); each field (L,)."""

    dl_direction: Vec3
    dl_color: Vec3
    pl_position: Vec3
    pl_color: Vec3
    pl_intensity: torch.Tensor


class Hit(NamedTuple):
    """The nearest hit of a ray batch: its kind, the EPSILON-offset point
    (the ray origin on a miss), the normalized normal (the direction on a
    miss), the material color and reflectivity (0 on a miss)."""

    kind: torch.Tensor
    point: Vec3
    normal: Vec3
    color: Vec3
    reflectivity: torch.Tensor


def vec_of(rows, *, dtype, device) -> Vec3:
    """Vec3 of (N,) components from an (N, 3) array."""
    a = torch.as_tensor(np.asarray(rows), dtype=dtype, device=device)
    return Vec3(a[..., 0], a[..., 1], a[..., 2])


def lights(dl_dir, pl_pos, *, dtype, device) -> Lights:
    """White lights: a directional one along ``dl_dir`` and a point one at
    ``pl_pos`` of intensity 10."""
    one = [[1.0, 1.0, 1.0]]
    kw = dict(dtype=dtype, device=device)
    return Lights(vec_of([dl_dir], **kw), vec_of(one, **kw),
                  vec_of([pl_pos], **kw), vec_of(one, **kw),
                  torch.tensor([10.0], **kw))
