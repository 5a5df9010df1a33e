"""The bounding volume hierarchy that the fused many-object kernel walks
(``csrc/mesh.cu::BvhTracer``), built once per cluster pack.

A leaf holds ``LEAF`` consecutive positions of the Morton-ordered sphere
table or triangle table (fewer at the end of a kind), never both kinds:
the spheres' leaves come first, then the triangles'. The leaves are
padded with empty ones (count 0) to a power of two P, and the internal
nodes form the implicit complete binary tree over them: node 1 is the
root, nodes 2i and 2i+1 are the children of node i, and nodes P .. 2P-1
are the leaves in order. Each internal box is the pairwise min/max of its
children's, level by level, so the pack's Morton order makes the tree
without moving an object.

A row of the table has the kernel tables' quarter-box layout, eight
float32: lo xyz, hi xyz, the count of real objects below the node, and
for a leaf its first position in the kernels' combined numbering
(spheres 0 .., triangles kb_sph * 128 ..). Every box is widened by the
quarter boxes' pad (``clusters.BOX_PAD``), so a node's float slab entry
time is never later than its children's and a hit's box always holds it.
An empty node's box is zeros; the walk rejects it by its count.
"""

from __future__ import annotations

import numpy as np
import torch

LEAF = 4  # objects per leaf
# the deepest tree the kernel walks (csrc/mesh.cu::BVH_STACK): a leaf
# depth of 24 is 2^24 leaves
MAX_DEPTH = 24


def leaf_extremes(lo_pts: np.ndarray, hi_pts: np.ndarray):
    """(L, 3) lo and hi of every ``LEAF`` consecutive objects and their
    (L,) counts, from the per-object extremes (m, 3) or (m, verts, 3) in
    table order; L = ceil(m / LEAF)."""
    verts = tuple(range(1, lo_pts.ndim - 1))
    lo, hi = lo_pts.min(axis=verts), hi_pts.max(axis=verts)
    m = lo.shape[0]
    pad = (-m) % LEAF
    lo = np.concatenate([lo, np.full((pad, 3), np.inf, lo.dtype)])
    hi = np.concatenate([hi, np.full((pad, 3), -np.inf, hi.dtype)])
    counts = np.minimum(m - np.arange(0, m, LEAF), LEAF)
    return (lo.reshape(-1, LEAF, 3).min(axis=1),
            hi.reshape(-1, LEAF, 3).max(axis=1), counts)


def node_table(sph, tri, kb_sph: int, pad: float, device) -> torch.Tensor:
    """The (2P, 8) float32 node table on ``device``. ``sph`` and ``tri``
    are ``leaf_extremes``' (lo, hi, counts) of the spheres' and the
    triangles' leaves; ``pad`` is the quarter boxes' pad."""
    f32 = torch.float32
    n_sph, n_tri = len(sph[2]), len(tri[2])
    # the triangles' leaves start at a multiple of their count's power of
    # two, so that one subtree holds them all and no other box mixes the
    # floor with spheres below it
    span = _pow2(n_tri)
    start = -(-n_sph // span) * span
    P = _pow2(start + n_tri)
    where = np.concatenate([np.arange(n_sph), start + np.arange(n_tri)])
    first = np.concatenate([np.arange(n_sph) * LEAF,
                            kb_sph * 128 + np.arange(n_tri) * LEAF])
    if first.size and first.max() >= 1 << 26:
        # a float32 holds every multiple of LEAF = 4 below 2^26 exactly
        raise ValueError(f"{first.max()} objects: past what the node "
                         f"table's float32 positions hold")
    lo = torch.full((2 * P, 3), float("inf"), dtype=f32)
    hi = torch.full((2 * P, 3), -float("inf"), dtype=f32)
    n = torch.zeros(2 * P, dtype=torch.int64)
    base = torch.zeros((2 * P, 1), dtype=f32)
    rows = torch.as_tensor(P + where, dtype=torch.int64)
    lo[rows] = torch.as_tensor(np.concatenate([sph[0], tri[0]])).to(f32)
    hi[rows] = torch.as_tensor(np.concatenate([sph[1], tri[1]])).to(f32)
    n[rows] = torch.as_tensor(np.concatenate([sph[2], tri[2]])).long()
    base[rows, 0] = torch.as_tensor(first).to(f32)
    level = P
    while level > 1:  # one level a pass, from the leaves up
        level //= 2
        kids = slice(2 * level, 4 * level)
        lo[level:2 * level] = lo[kids].reshape(-1, 2, 3).amin(1)
        hi[level:2 * level] = hi[kids].reshape(-1, 2, 3).amax(1)
        n[level:2 * level] = n[kids].reshape(-1, 2).sum(1)
    ok = (n > 0)[:, None]
    # empty nodes (infinite boxes) are skipped by their count, not their box
    lo = torch.where(ok, lo - pad, 0.0)
    hi = torch.where(ok, hi + pad, 0.0)
    table = torch.cat([lo, hi, n[:, None].to(f32), base], dim=1)
    return table.to(device).contiguous()


def _pow2(n: int) -> int:
    """The least power of two >= n (1 for n <= 1)."""
    return 1 << max(n - 1, 0).bit_length()


def depth(n_nodes: int) -> int:
    """The leaves' depth below the root of a table of ``n_nodes`` rows."""
    return (n_nodes // 2).bit_length() - 1
