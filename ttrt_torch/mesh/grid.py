"""Uniform grid over the many-object scene and its batched 3D-DDA walk
(port of ``ttrt.mesh.grid``).

The grid is built on the host in NumPy, once a scene, as the JAX package
builds it: the same resolution rule, the same ``(Gx, Gy, Gz, K)`` table of
object ids padded with -1 (each cell's ids in ascending order), and
``origin`` and ``cell_size`` computed in float64 and rounded to the scene's
dtype. Ids in [0, n_spheres) are spheres, the rest triangles.

``traverse_grid`` marches every ray through the table in one masked loop
over the batch: each step tests the K candidates of each ray's cell and
crosses the nearest cell boundary. A ray is done when its best hit lies
within the cell just tested or it leaves the grid; the loop ends when
every ray is done. It is the CPU path of ``mesh.scene.trace_ray_mesh``;
rays on the card go through the cluster-culled kernel instead.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ttrt_torch.mesh.dense import NearestHit
from ttrt_torch.mesh.triangles import Triangles, ray_triangle
from ttrt_torch.render.intersect import ray_sphere_t0
from ttrt_torch.vec import Vec3, scalar_like

GridHit = NearestHit  # (t, obj): inf and -1 on a miss, as every walk gives


class UniformGrid(NamedTuple):
    """The cell table and its placement: ``cells`` is (Gx, Gy, Gz, K) int32
    (-1 an empty slot); ``origin`` (the box's low corner) and
    ``cell_size`` hold 0-dim tensors in the scene's dtype."""

    cells: torch.Tensor
    origin: Vec3
    cell_size: Vec3

    @property
    def dims(self) -> Tuple[int, int, int]:
        return tuple(self.cells.shape[:3])

    @property
    def capacity(self) -> int:
        return self.cells.shape[3]


def grid_from_numpy(cells, origin, cell_size, *, dtype,
                    device) -> UniformGrid:
    """A ``UniformGrid`` from NumPy arrays: the (Gx, Gy, Gz, K) table and
    the three components of ``origin`` and ``cell_size``. This carries the
    JAX package's grid into the port."""
    def vec(v):
        return Vec3(*(torch.tensor(float(c), dtype=dtype, device=device)
                      for c in np.asarray(v, np.float64)))

    return UniformGrid(
        torch.tensor(np.asarray(cells, np.int32), device=device),
        vec(origin), vec(cell_size))


def _host64(v: torch.Tensor) -> np.ndarray:
    return v.detach().cpu().numpy().astype(np.float64)


def build_grid(spheres, triangles: Optional[Triangles],
               resolution: Optional[Tuple[int, int, int]] = None, *, dtype,
               device, np_spheres=None, np_tris: Optional[dict] = None
               ) -> UniformGrid:
    """Rasterize every object's box into the cell table. The resolution
    defaults to about cbrt(objects) cells an axis, scaled by the scene
    box's aspect, each axis in [1, 64]; K grows to the fullest cell.
    ``np_spheres`` ((n, 3) centers, (n,) radii) and ``np_tris`` (a
    ``Triangles.create_np`` dict) give the geometry as host arrays; without
    them it is read from the tensors."""
    lo_list, hi_list = [], []
    if spheres is not None and spheres.count:
        if np_spheres is not None:
            c = np.asarray(np_spheres[0], np.float64)
            r = np.asarray(np_spheres[1], np.float64)[:, None]
        else:
            c = np.stack([_host64(v) for v in spheres.center], -1)
            r = _host64(spheres.radius)[:, None]
        lo_list.append(c - r)
        hi_list.append(c + r)
    if triangles is not None and triangles.count:
        if np_tris is None:
            np_tris = {k: np.stack([_host64(v) for v in getattr(triangles, k)],
                                   -1) for k in ("v0", "e1", "e2")}
        tlo, thi = Triangles.aabbs_np(np_tris)
        lo_list.append(tlo)
        hi_list.append(thi)
    if not lo_list:
        raise ValueError("a grid needs at least one object")
    lo = np.concatenate(lo_list)
    hi = np.concatenate(hi_list)
    n_obj = lo.shape[0]

    world_lo = lo.min(axis=0) - 1e-4
    world_hi = hi.max(axis=0) + 1e-4
    extent = np.maximum(world_hi - world_lo, 1e-6)
    if resolution is None:
        target = max(1.0, float(n_obj) ** (1.0 / 3.0))
        geo_mean = float(np.exp(np.log(extent).mean()))
        dims = np.clip(np.round(target * extent / geo_mean).astype(int), 1,
                       64)
        resolution = (int(dims[0]), int(dims[1]), int(dims[2]))
    gx, gy, gz = resolution
    cell = extent / np.array([gx, gy, gz], np.float64)
    top = np.array([gx - 1, gy - 1, gz - 1])
    lo_idx = np.clip(((lo - world_lo) / cell).astype(int), 0, top)
    hi_idx = np.clip(((hi - world_lo) / cell).astype(int), 0, top)

    # every (cell, object) pair, object-major, then stably by cell: each
    # cell lists its objects in ascending id order, as JAX's buckets do
    span = hi_idx - lo_idx + 1
    count = span.prod(axis=1)
    obj = np.repeat(np.arange(n_obj), count)
    local = np.arange(count.sum()) - np.repeat(np.cumsum(count) - count,
                                               count)
    syz = np.repeat(span[:, 1] * span[:, 2], count)
    sz = np.repeat(span[:, 2], count)
    ix = np.repeat(lo_idx[:, 0], count) + local // syz
    iy = np.repeat(lo_idx[:, 1], count) + (local % syz) // sz
    iz = np.repeat(lo_idx[:, 2], count) + local % sz
    cell_id = (ix * gy + iy) * gz + iz
    order = np.argsort(cell_id, kind="stable")
    cell_id, obj = cell_id[order], obj[order]
    slot = np.arange(cell_id.size) - np.searchsorted(cell_id, cell_id)
    cells = np.full((gx * gy * gz, int(slot.max()) + 1), -1, np.int32)
    cells[cell_id, slot] = obj
    return grid_from_numpy(cells.reshape(gx, gy, gz, -1), world_lo, cell,
                           dtype=dtype, device=device)


def _safe_inv(x: torch.Tensor) -> torch.Tensor:
    """1/x; 0 (and |x| <= 1e-30) -> +-3e37, an axis the walk never
    crosses."""
    big = scalar_like(3.0e37, x)
    big = torch.where(x >= 0, big, -big)
    return torch.where(x.abs() > 1e-30, 1.0 / torch.where(x == 0, 1.0, x),
                       big)


def traverse_grid(grid: UniformGrid, spheres, triangles: Optional[Triangles],
                  o: Vec3, d: Vec3) -> GridHit:
    """The nearest hit of every ray by the grid's 3D-DDA: the K candidates
    of each visited cell are tested with the reference's quadratic
    (``ray_sphere_t0``) and ``ray_triangle``, the nearest by t, the lower
    id on a tie."""
    dtype, shape = o.x.dtype, o.x.shape
    gx, gy, gz = grid.dims
    n_spheres = spheres.count if spheres is not None else 0
    n_tris = triangles.count if triangles is not None else 0
    rows = grid.cells.reshape(-1, grid.capacity)
    if n_spheres:
        sph = torch.stack([*spheres.center, spheres.radius], -1)
    if n_tris:
        tri = torch.stack([*triangles.v0, *triangles.e1, *triangles.e2], -1)
    inv = Vec3(*(_safe_inv(c) for c in d))
    size = grid.cell_size
    wlo = grid.origin
    whi = Vec3(wlo.x + size.x * gx, wlo.y + size.y * gy, wlo.z + size.z * gz)

    # the ray's interval inside the grid's box (slabs)
    t1 = Vec3(*((a - b) * i for a, b, i in zip(wlo, o, inv)))
    t2 = Vec3(*((a - b) * i for a, b, i in zip(whi, o, inv)))
    t_enter = torch.maximum(torch.maximum(torch.minimum(t1.x, t2.x),
                                          torch.minimum(t1.y, t2.y)),
                            torch.minimum(t1.z, t2.z))
    t_exit = torch.minimum(torch.minimum(torch.maximum(t1.x, t2.x),
                                         torch.maximum(t1.y, t2.y)),
                           torch.maximum(t1.z, t2.z))
    t_start = torch.clamp_min(t_enter, 0.0)
    active = ~(t_exit < t_start)

    idx, step, tmax, tdelta = [], [], [], []
    for oc, dc, ic, lw, cs, g in zip(o, d, inv, wlo, size, (gx, gy, gz)):
        p = oc + t_start * dc
        i = torch.clamp(((p - lw) / cs).to(torch.int32), 0, g - 1)
        s = torch.where(dc > 0, 1, torch.where(dc < 0, -1, 0)).to(
            torch.int32)
        bound = (lw + (i + torch.clamp_min(s, 0)).to(dtype) * cs - oc) * ic
        idx.append(i)
        step.append(s)
        tmax.append(torch.where(s == 0, torch.inf, bound))
        tdelta.append(torch.abs(cs * ic))

    best_t = torch.full(shape, torch.inf, dtype=dtype, device=o.x.device)
    best_obj = torch.full(shape, -1, dtype=torch.int32, device=o.x.device)
    for _ in range(gx + gy + gz + 2):
        if not bool(active.any()):
            break
        slots = rows[((idx[0] * gy + idx[1]) * gz + idx[2]).long()]
        for k in range(grid.capacity):
            obj = slots[..., k]
            valid = active & (obj >= 0)
            if n_spheres:
                row = sph[torch.clamp(obj, 0, n_spheres - 1).long()]
                t0, hit = ray_sphere_t0(o, d, Vec3(row[..., 0], row[..., 1],
                                                   row[..., 2]), row[..., 3])
                take = valid & (obj < n_spheres) & hit & (t0 < best_t)
                best_t = torch.where(take, t0, best_t)
                best_obj = torch.where(take, obj, best_obj)
            if n_tris:
                row = tri[torch.clamp(obj - n_spheres, 0, n_tris - 1).long()]
                v0, e1, e2 = (Vec3(*row[..., j:j + 3].unbind(-1))
                              for j in (0, 3, 6))
                tt, hit = ray_triangle(o, d, v0, e1, e2)
                take = valid & (obj >= n_spheres) & hit & (tt < best_t)
                best_t = torch.where(take, tt, best_t)
                best_obj = torch.where(take, obj, best_obj)

        # done when the best hit lies in this cell, or the ray leaves the
        # grid at its boundary; else cross the nearest boundary
        t_cell_exit = torch.minimum(torch.minimum(tmax[0], tmax[1]), tmax[2])
        go_x = (tmax[0] <= tmax[1]) & (tmax[0] <= tmax[2])
        go_y = ~go_x & (tmax[1] <= tmax[2])
        go_z = ~go_x & ~go_y
        out = t_cell_exit > t_exit
        for a, (go, g) in enumerate(((go_x, gx), (go_y, gy), (go_z, gz))):
            n = torch.where(go, idx[a] + step[a], idx[a])
            out = out | (n < 0) | (n >= g)
            idx[a] = torch.clamp(n, 0, g - 1)
            tmax[a] = torch.where(go, tmax[a] + tdelta[a], tmax[a])
        active = active & ~(best_t <= t_cell_exit) & ~out
    hit_ok = torch.isfinite(best_t)
    return GridHit(torch.where(hit_ok, best_t, torch.inf),
                   torch.where(hit_ok, best_obj, -1))
