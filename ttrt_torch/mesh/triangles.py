"""Triangle primitives: SoA batch and batched Moller-Trumbore (port of
``ttrt.mesh.triangles``).

The reference has no triangle path ("other shapes for objects" is a roadmap
item, README.md:19). The test shares the epsilon conventions of the
reference's plane test (TerminalRayTracer.c:680,685): reject near-parallel
rays via |det| <= 1e-5 and near-origin hits via t <= 1e-5.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ttrt_torch.config import constants
from ttrt_torch.scene import Materials
from ttrt_torch.vec import Vec3


class Triangles(NamedTuple):
    """SoA triangle batch: vertices (M,) per component plus a per-triangle
    material. The unit geometric normal normalize(cross(e1, e2)) is
    precomputed at build time."""

    v0: Vec3
    e1: Vec3  # v1 - v0
    e2: Vec3  # v2 - v0
    normal: Vec3
    material: Materials

    @property
    def count(self) -> int:
        return self.v0.x.shape[-1]

    @staticmethod
    def create_np(vertices, colors, reflectivity, specularity=100.0) -> dict:
        """Host-side precompute: vertices (M, 3, 3) -> dict of float64
        arrays (v0/e1/e2/normal (M, 3), color (M, 3), reflectivity and
        specularity (M,)), which the cluster build reads directly."""
        v = np.asarray(vertices, np.float64)
        v0, v1, v2 = v[:, 0], v[:, 1], v[:, 2]
        e1 = v1 - v0
        e2 = v2 - v0
        n = np.cross(e1, e2)
        norm = np.linalg.norm(n, axis=-1, keepdims=True)
        n = n / np.where(norm == 0.0, 1.0, norm)
        m = v.shape[0]
        return {
            "v0": v0, "e1": e1, "e2": e2, "normal": n,
            "color": np.broadcast_to(np.asarray(colors, np.float64), (m, 3)),
            "reflectivity": np.broadcast_to(np.asarray(reflectivity), m),
            "specularity": np.broadcast_to(np.asarray(specularity), m),
        }

    @staticmethod
    def from_np(h: dict, *, dtype, device) -> "Triangles":
        """Tensors from a ``create_np`` dict."""
        def t(arr):
            # a copy: the dict's broadcast arrays are read-only views
            return torch.as_tensor(np.array(arr), dtype=dtype,
                                   device=device)

        def vec(arr):
            return Vec3(*(t(arr[:, i]) for i in range(3)))

        return Triangles(
            v0=vec(h["v0"]), e1=vec(h["e1"]), e2=vec(h["e2"]),
            normal=vec(h["normal"]),
            material=Materials(vec(h["color"]), t(h["reflectivity"]),
                               t(h["specularity"])),
        )

    @staticmethod
    def aabbs_np(h: dict) -> Tuple[np.ndarray, np.ndarray]:
        """Per-triangle (lo, hi) boxes from a ``create_np`` dict."""
        v0 = h["v0"]
        v1, v2 = v0 + h["e1"], v0 + h["e2"]
        return (np.minimum(np.minimum(v0, v1), v2),
                np.maximum(np.maximum(v0, v1), v2))


def ray_triangle(o: Vec3, d: Vec3, v0: Vec3, e1: Vec3, e2: Vec3):
    """Moller-Trumbore over a ray batch against triangles that broadcast
    against it. Returns (t, hit); t is garbage where hit is False."""
    p = d.cross(e2)
    det = e1.dot(p)
    ok = torch.abs(det) > constants.PLANE_DENOM_EPS
    inv = 1.0 / torch.where(ok, det, 1.0)
    s = o - v0
    u = s.dot(p) * inv
    q = s.cross(e1)
    v = d.dot(q) * inv
    t = e2.dot(q) * inv
    hit = (ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t > constants.PLANE_T_EPS))
    return t, hit


def floor_mesh_np(y: float = -2.0, half_extent: float = 20.0,
                  cells: int = 16, even_color=(1.0, 1.0, 1.0),
                  odd_color=(1.0, 0.0, 0.0),
                  reflectivity: float = 0.2) -> dict:
    """Checkerboard floor as a triangle mesh: cells x cells quads, two
    triangles each wound counter-clockwise seen from +y (normal up),
    colored by the floor(x)+floor(z) parity of the reference's plane
    (TerminalRayTracer.c:850) at the cell corner."""
    xs = np.linspace(-half_extent, half_extent, cells + 1)
    zs = np.linspace(-half_extent, half_extent, cells + 1)
    tris = []
    cols = []
    for i in range(cells):
        for j in range(cells):
            x0, x1 = xs[i], xs[i + 1]
            z0, z1 = zs[j], zs[j + 1]
            a = (x0, y, z0)
            b = (x1, y, z0)
            c = (x1, y, z1)
            dd = (x0, y, z1)
            tris.append((a, c, b))
            tris.append((a, dd, c))
            parity = (int(np.floor(x0)) + int(np.floor(z0))) & 1
            col = odd_color if parity else even_color
            cols.append(col)
            cols.append(col)
    return Triangles.create_np(np.asarray(tris), np.asarray(cols),
                               reflectivity, 100.0)


def floor_mesh(y: float = -2.0, half_extent: float = 20.0, cells: int = 16,
               *, dtype, device) -> Triangles:
    """The floor mesh of ``floor_mesh_np`` as tensors."""
    return Triangles.from_np(floor_mesh_np(y, half_extent, cells),
                             dtype=dtype, device=device)
