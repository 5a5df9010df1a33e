"""Morton-clustered geometry pack for the many-object kernels (port of
``ttrt.mesh.clusters``).

Spheres and triangles are sorted by a 30-bit Morton key and cut into
clusters of 128 objects, each with an AABB and four quarter AABBs (32
objects each). The build runs once per scene on the host, in NumPy, and
gives arrays byte-equal to the JAX package's, so that both packages cull
the same boxes.

The CUDA kernels read a re-laid-out copy of these tables, made here once
per pack (``kernel_tables``, the pack's ``tables``): one 16-byte record
per sphere (cx cy cz ccr2) and three per triangle (v0 e1 e2) in Morton
order, so a warp whose rays test the same object reads one broadcast
address; materials, normals and ids beside them; and the quarter AABBs
with their object counts, and the node table of the tree over the same
objects that the fused kernel walks (``mesh.bvh``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ttrt_torch.mesh import bvh

BLOCK = 128  # objects per cluster
GROUPS = BLOCK // 8  # 8-object groups per cluster (the table's minor axis)
QUARTERS = 4  # culling granularity inside a cluster
QBLOCK = BLOCK // QUARTERS  # 32 Morton-consecutive objects
PAGE = 1024  # object columns are padded to a multiple of this

# padding sphere: ccr2 huge, so disc < 0 for every real ray
_PAD_CCR2 = 1.0e30
# Quarter AABBs are widened by BOX_PAD x (1 + the scene's largest box
# coordinate) in the kernel tables. A narrow test may accept a ray that
# passes up to a few 1e-3 outside a small sphere (the expanded quadratic's
# c term rounds to about 3e-4 at |o|^2 + |C|^2 ~ 1600, and the sphere's
# radius divides that), and such a hit must not be culled, or the culled
# kernels would differ from their exhaustive plain versions. At the
# many-object scene's extent of 20 the pad is 0.042, ten times that error.
BOX_PAD = 2e-3


class KernelTables(NamedTuple):
    """The pack as the CUDA kernels read it (float32 unless noted)."""

    sph: torch.Tensor  # (Ns, 4) cx cy cz ccr2, Morton order
    sph_mat: torch.Tensor  # (Ns, 4) cr cg cb refl
    sph_spec: torch.Tensor  # (Ns,)
    sph_id: torch.Tensor  # (Ns,) int32 original id, -1 on padding
    tri: torch.Tensor  # (Nt, 12) v0xyz e1xyz e2xyz 0 0 0
    tri_nrm: torch.Tensor  # (Nt, 4) nx ny nz 0
    tri_mat: torch.Tensor  # (Nt, 4) cr cg cb refl
    tri_spec: torch.Tensor  # (Nt,)
    tri_id: torch.Tensor  # (Nt,) int32
    qbox: torch.Tensor  # (K*4, 8) lo xyz, hi xyz (widened), n_obj, 0
    kb_sph: int
    kb_tri: int
    # (2P, 8) the tree's nodes (mesh.bvh): lo xyz, hi xyz (widened), n_obj,
    # a leaf's first position; None on a shard of the tables
    nodes: Optional[torch.Tensor] = None


class ClusterPack(NamedTuple):
    """Packed geometry, float32 tensors (int32 for the valid flags).

    ``sph``: (10, KB, 8, 16); [c, k, s, g] is component c of the sphere at
    Morton position ``k*128 + g*8 + s``. Rows: cx cy cz ccr2 id cr cg cb
    refl spec, with ccr2 = |C|^2 - r^2 and id the original sphere index
    (-1 on padding).
    ``tri``: (18, KB, 8, 16), rows v0xyz e1xyz e2xyz id nx ny nz cr cg cb
    refl spec; triangle ids follow the sphere ids.
    ``*_lo/hi``: (KB, 3) cluster AABBs (spheres inflated by their radius),
    ``*_valid``: (KB,) 1 where a cluster has real members,
    ``*_lo_q/hi_q``: (KB, 4, 3) quarter AABBs, NaN on all-padding quarters.
    ``tables``: the CUDA kernels' layout of the same objects
    (``kernel_tables``), made by ``pack_clusters``.
    """

    sph: torch.Tensor
    sph_lo: torch.Tensor
    sph_hi: torch.Tensor
    sph_valid: torch.Tensor
    tri: torch.Tensor
    tri_lo: torch.Tensor
    tri_hi: torch.Tensor
    tri_valid: torch.Tensor
    sph_lo_q: torch.Tensor
    sph_hi_q: torch.Tensor
    tri_lo_q: torch.Tensor
    tri_hi_q: torch.Tensor
    tables: Optional[KernelTables] = None

    @property
    def kb_sph(self) -> int:
        return self.sph_lo.shape[0]

    @property
    def kb_tri(self) -> int:
        return self.tri_lo.shape[0]


def _morton_order(points: np.ndarray) -> np.ndarray:
    """Sort order by 30-bit 3D Morton code (10 bits an axis)."""
    lo = points.min(axis=0)
    span = np.maximum(points.max(axis=0) - lo, 1e-9)
    q = np.clip(((points - lo) / span * 1023.0), 0, 1023).astype(np.uint64)

    def spread(x):
        x = (x | (x << 16)) & np.uint64(0x030000FF)
        x = (x | (x << 8)) & np.uint64(0x0300F00F)
        x = (x | (x << 4)) & np.uint64(0x030C30C3)
        x = (x | (x << 2)) & np.uint64(0x09249249)
        return x

    key = (spread(q[:, 0]) << np.uint64(2)) | (
        spread(q[:, 1]) << np.uint64(1)) | spread(q[:, 2])
    return np.argsort(key, kind="stable")


def _pad_cols(a: np.ndarray, fill: float) -> np.ndarray:
    pad = (-a.shape[0]) % PAGE
    if pad:
        a = np.concatenate([a, np.full((pad,), fill, a.dtype)])
    return a


def _table(rows) -> np.ndarray:
    """list of (n_pad,) columns -> (C, n_pad//128, 8, 16)."""
    return np.stack([r.reshape(-1, GROUPS, 8).transpose(0, 2, 1)
                     for r in rows], axis=0).astype(np.float32)


def _boxes(lo_pts: np.ndarray, hi_pts: np.ndarray, kb: int):
    """Cluster and quarter AABBs over the real members of each cluster.
    ``lo_pts``/``hi_pts``: (m, 3) or (m, verts, 3) per-object extremes."""
    f32 = np.float32
    m = lo_pts.shape[0]
    axes = tuple(range(lo_pts.ndim - 1))
    lo = np.full((kb, 3), np.inf, f32)
    hi = np.full((kb, 3), -np.inf, f32)
    valid = np.zeros((kb,), np.int32)
    lo_q = np.full((kb, QUARTERS, 3), np.nan, f32)
    hi_q = np.full((kb, QUARTERS, 3), np.nan, f32)
    for k in range(kb):
        end = min((k + 1) * BLOCK, m)
        if end > k * BLOCK:
            sl = slice(k * BLOCK, end)
            lo[k] = lo_pts[sl].min(axis=axes)
            hi[k] = hi_pts[sl].max(axis=axes)
            valid[k] = 1
        for q in range(QUARTERS):
            qs = k * BLOCK + q * QBLOCK
            qe = min(qs + QBLOCK, m)
            if qe > qs:
                lo_q[k, q] = lo_pts[qs:qe].min(axis=axes)
                hi_q[k, q] = hi_pts[qs:qe].max(axis=axes)
    return lo, hi, valid, lo_q, hi_q


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy().astype(np.float64)


def pack_clusters(spheres, triangles) -> ClusterPack:
    """Morton-sort, cut into 128-object clusters, compute the AABBs and lay
    out the tables, on the host from float32 copies of the geometry; the
    result lives on the geometry's device."""
    f32 = np.float32
    n_spheres = spheres.count if spheres is not None else 0
    device = (spheres.radius.device if spheres is not None
              else triangles.v0.x.device)

    if n_spheres:
        c = np.stack([_host(v) for v in spheres.center], -1).astype(f32)
        r = _host(spheres.radius).astype(f32)
        mat = spheres.material
        col3 = np.stack([_host(v) for v in mat.color], -1).astype(f32)
        refl = _host(mat.reflectivity).astype(f32)
        spec = _host(mat.specularity).astype(f32)
        order = _morton_order(c)
        c, r = c[order], r[order]
        col3, refl, spec = col3[order], refl[order], spec[order]
        ccr2 = (c[:, 0] ** 2 + c[:, 1] ** 2 + c[:, 2] ** 2 - r * r).astype(f32)
        ids = order.astype(f32)
        cols = [
            _pad_cols(c[:, 0], 0.0), _pad_cols(c[:, 1], 0.0),
            _pad_cols(c[:, 2], 0.0), _pad_cols(ccr2, _PAD_CCR2),
            _pad_cols(ids, -1.0),
            _pad_cols(col3[:, 0], 0.0), _pad_cols(col3[:, 1], 0.0),
            _pad_cols(col3[:, 2], 0.0), _pad_cols(refl, 0.0),
            _pad_cols(spec, 0.0),
        ]
        sph = _table(cols)
        sph_ext = (c - r[:, None], c + r[:, None])
        sph_box = _boxes(*sph_ext, sph.shape[1])
    else:
        sph = np.zeros((10, 0, 8, GROUPS), f32)
        sph_ext = (np.zeros((0, 3), f32), np.zeros((0, 3), f32))
        sph_box = _boxes(*sph_ext, 0)

    if triangles is not None and triangles.count:
        vec = lambda v: np.stack([_host(a) for a in v], -1).astype(f32)  # noqa: E731
        m = triangles.material
        h = {"v0": vec(triangles.v0), "e1": vec(triangles.e1),
             "e2": vec(triangles.e2), "normal": vec(triangles.normal),
             "color": vec(m.color),
             "reflectivity": _host(m.reflectivity).astype(f32),
             "specularity": _host(m.specularity).astype(f32)}
        v0, e1, e2 = h["v0"], h["e1"], h["e2"]
        centroid = v0 + (e1 + e2) / 3.0
        order = _morton_order(centroid)
        v0, e1, e2 = v0[order], e1[order], e2[order]
        nrm, tcol = h["normal"][order], h["color"][order]
        trefl, tspec = h["reflectivity"][order], h["specularity"][order]
        ids = (order + n_spheres).astype(f32)
        cols = ([_pad_cols(v0[:, i], 0.0) for i in range(3)]
                + [_pad_cols(e1[:, i], 0.0) for i in range(3)]
                + [_pad_cols(e2[:, i], 0.0) for i in range(3)]
                + [_pad_cols(ids, -1.0)]
                + [_pad_cols(nrm[:, i], 0.0) for i in range(3)]
                + [_pad_cols(tcol[:, i], 0.0) for i in range(3)]
                + [_pad_cols(trefl, 0.0), _pad_cols(tspec, 0.0)])
        tri = _table(cols)
        pts = np.stack([v0, v0 + e1, v0 + e2], axis=1)  # (m, 3 verts, 3)
        tri_ext = (pts, pts)
        tri_box = _boxes(pts, pts, tri.shape[1])
    else:
        tri = np.zeros((18, 0, 8, GROUPS), f32)
        tri_ext = (np.zeros((0, 3), f32), np.zeros((0, 3), f32))
        tri_box = _boxes(*tri_ext, 0)

    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    s_lo, s_hi, s_valid, s_lo_q, s_hi_q = sph_box
    t_lo, t_hi, t_valid, t_lo_q, t_hi_q = tri_box
    pack = ClusterPack(t(sph), t(s_lo), t(s_hi), t(s_valid),
                       t(tri), t(t_lo), t(t_hi), t(t_valid),
                       t(s_lo_q), t(s_hi_q), t(t_lo_q), t(t_hi_q))
    leaves = (bvh.leaf_extremes(*sph_ext), bvh.leaf_extremes(*tri_ext))
    return pack._replace(tables=kernel_tables(pack, leaves))


def _morton_rows(table: torch.Tensor) -> torch.Tensor:
    """(C, KB, 8, 16) pack table -> (KB*128, C) rows in Morton order
    (row k*128 + g*8 + s)."""
    c = table.shape[0]
    return table.permute(1, 3, 2, 0).reshape(-1, c)


def pack_rows(pack: ClusterPack):
    """The pack's real objects as id-ordered rows: spheres (n, 9) = cx cy
    cz ccr2 cr cg cb refl spec, triangles (m, 16) = v0 e1 e2 nxyz cr cg cb
    refl spec; triangle ids follow the sphere ids."""
    def by_id(rows, id_col):
        rows = rows[rows[:, id_col] >= 0]
        return rows[torch.argsort(rows[:, id_col])]

    sph = by_id(_morton_rows(pack.sph), 4)
    tri = by_id(_morton_rows(pack.tri), 9)
    keep_s = [0, 1, 2, 3, 5, 6, 7, 8, 9]
    keep_t = [0, 1, 2, 3, 4, 5, 6, 7, 8, 10, 11, 12, 13, 14, 15, 16, 17]
    return sph[:, keep_s], tri[:, keep_t]


def quarter_boxes(pack: ClusterPack):
    """(K*4, 3) lo and hi of the quarter AABBs as built, row sub*4 + q
    (spheres' subclusters, then the triangles'); NaN on empty quarters
    (``_aabb_table``, mesh_fused.py:117)."""
    lo = torch.cat([pack.sph_lo_q, pack.tri_lo_q], dim=0).reshape(-1, 3)
    hi = torch.cat([pack.sph_hi_q, pack.tri_hi_q], dim=0).reshape(-1, 3)
    return lo, hi


def kernel_tables(pack: ClusterPack, leaves) -> KernelTables:
    """The CUDA kernels' layout of ``pack``, built on the pack's device;
    ``leaves`` are ``bvh.leaf_extremes`` of its spheres and triangles in
    Morton order, from the per-object extremes of its quarter boxes."""
    s = _morton_rows(pack.sph)
    t = _morton_rows(pack.tri)
    counts = [(rows[:, col] >= 0).reshape(-1, QUARTERS, QBLOCK).sum(-1)
              .reshape(-1) for rows, col in ((s, 4), (t, 9))]
    n_obj = torch.cat(counts).float()
    lo, hi = quarter_boxes(pack)
    ok = n_obj[:, None] > 0
    # empty quarters (NaN boxes) are skipped by their count, not their box
    lo = torch.where(ok, lo, 0.0).float()
    hi = torch.where(ok, hi, 0.0).float()
    pad = (BOX_PAD * (1.0 + float(torch.cat([lo, hi], dim=1).abs().max()))
           if ok.any() else 0.0)
    qbox = torch.cat([lo - pad, hi + pad, n_obj[:, None],
                      torch.zeros_like(n_obj[:, None])], dim=1)
    z = torch.zeros_like(t[:, :3])
    return KernelTables(
        sph=s[:, 0:4].contiguous(), sph_mat=s[:, 5:9].contiguous(),
        sph_spec=s[:, 9].contiguous(),
        sph_id=s[:, 4].to(torch.int32).contiguous(),
        tri=torch.cat([t[:, 0:9], z], dim=1).contiguous(),
        tri_nrm=torch.cat([t[:, 10:13], z[:, :1]], dim=1).contiguous(),
        tri_mat=t[:, 13:17].contiguous(), tri_spec=t[:, 17].contiguous(),
        tri_id=t[:, 9].to(torch.int32).contiguous(),
        qbox=qbox.contiguous(), kb_sph=pack.kb_sph, kb_tri=pack.kb_tri,
        nodes=bvh.node_table(*leaves, pack.kb_sph, pad, lo.device),
    )
