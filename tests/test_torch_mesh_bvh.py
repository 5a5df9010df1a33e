"""The tree that the fused many-object kernel walks (``mesh/bvh.py``, the
kernel tables' ``nodes``), on the CPU: its leaves hold every object once,
each parent box holds its children's, its depth fits the kernel's stack,
and its boxes cull exactly (the nearest hit's leaf and every ancestor of
it are entered no later than the hit; so is every shadow ray's blocker,
before the point light). Packs: the 10k-sphere scene, three spheres,
triangles alone, and spheres and triangles whose last leaves are partial.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_mesh import _rays, _tv
from ttrt_torch import assets
from ttrt_torch.mesh import bvh
from ttrt_torch.mesh.clusters import BLOCK, pack_clusters, pack_rows
from ttrt_torch.mesh.dense import _tri_t, dense_nearest, sphere_blocks
from ttrt_torch.mesh.scene import many_sphere_scene

torch.set_num_threads(1)  # the test workers share the cores

MESH_CU = (Path(__file__).resolve().parent.parent / "ttrt_torch" / "kernels"
           / "csrc" / "mesh.cu")
PACKS = ["10k", "3_spheres", "triangles", "partial"]


def _scene(n, cells=16):
    return many_sphere_scene(assets.load_skybox("colors", device="cpu"), n,
                             32, 16, device="cpu", floor_cells=cells)


def _pack(kind):
    if kind == "10k":
        return _scene(10_000).clusters
    if kind == "3_spheres":
        return pack_clusters(_scene(3).spheres, None)
    if kind == "triangles":
        return pack_clusters(None, _scene(1, cells=5).triangles)
    return _scene(2241, cells=3).clusters  # 2241 and 18: partial leaves


def _objects(tab):
    """(real objects' combined positions, their ids), spheres first."""
    tri0 = tab.kb_sph * BLOCK
    pos = torch.cat([torch.nonzero(tab.sph_id >= 0)[:, 0],
                     tri0 + torch.nonzero(tab.tri_id >= 0)[:, 0]])
    ids = torch.cat([tab.sph_id[tab.sph_id >= 0], tab.tri_id[tab.tri_id >= 0]])
    return pos, ids


def _leaf_of(nodes, pos):
    """The leaf row that holds each combined position (-1 for none)."""
    P = nodes.shape[0] // 2
    first, n = nodes[P:, 7].long(), nodes[P:, 6].long()
    held = ((pos[:, None] >= first[None]) & (pos[:, None] < first + n)
            & (n > 0))
    assert int(held.sum(1).max()) <= 1
    return torch.where(held.any(1), P + held.long().argmax(1), -1)


@pytest.mark.parametrize("kind", PACKS)
def test_leaves_hold_every_object_once(kind):
    """Each real object lies in exactly one leaf, leaves never mix kinds
    or hold more than LEAF objects, padding leaves count 0, and every
    node's count is its subtree's objects."""
    tab = _pack(kind).tables
    nodes = tab.nodes
    P = nodes.shape[0] // 2
    assert P & (P - 1) == 0 and nodes.shape == (2 * P, 8)
    pos, _ = _objects(tab)
    leaf = _leaf_of(nodes, pos)
    assert bool((leaf >= P).all())
    n = nodes[:, 6].long()
    assert int(n[P:].sum()) == pos.numel() == int(n[1])
    assert int(n[P:].max()) <= bvh.LEAF
    first = nodes[P:, 7].long()
    tri0 = tab.kb_sph * BLOCK
    real = n[P:] > 0
    assert bool(((first[real] < tri0) == (first[real] + n[P:][real] <= tri0))
                .all())
    assert bool((nodes[P:][~real] == 0).all())
    kids = n[2:].reshape(-1, 2).sum(1)
    assert torch.equal(n[1:P], kids[:P - 1])


@pytest.mark.parametrize("kind", PACKS)
def test_parent_boxes_contain_their_children(kind):
    """Exact float32 comparisons: a parent's widened box holds each
    non-empty child's; every real leaf's holds its objects' extremes
    widened by the quarter boxes' pad."""
    tab = _pack(kind).tables
    nodes = tab.nodes
    P = nodes.shape[0] // 2
    lo, hi, n = nodes[:, :3], nodes[:, 3:6], nodes[:, 6]
    c = torch.nonzero(n[2:] > 0)[:, 0] + 2
    assert bool((lo[c // 2] <= lo[c]).all() & (hi[c // 2] >= hi[c]).all())
    qbox = tab.qbox[tab.qbox[:, 6] > 0]
    # the same per-object extremes and pad: the union of the real leaves'
    # boxes is the union of the quarters'
    real = nodes[P:][nodes[P:, 6] > 0]
    assert torch.equal(real[:, :3].amin(0), qbox[:, :3].amin(0))
    assert torch.equal(real[:, 3:6].amax(0), qbox[:, 3:6].amax(0))


def test_depth_fits_the_kernel_stack_up_to_2_to_the_20_objects():
    """bvh.MAX_DEPTH is mesh.cu's BVH_STACK, and the tables of 2^20
    objects, spheres or triangles or both, are no deeper."""
    stack = int(re.search(r"constexpr int BVH_STACK = (\d+);",
                          MESH_CU.read_text()).group(1))
    assert stack == bvh.MAX_DEPTH
    one = np.zeros((1, 3), np.float32)
    for n_sph, n_tri in ((1 << 20, 0), (0, 1 << 20), ((1 << 20) - 512, 512),
                         (1 << 19, 1 << 19)):
        sph = bvh.leaf_extremes(np.repeat(one, n_sph, 0),
                                np.repeat(one, n_sph, 0))
        tri = bvh.leaf_extremes(np.repeat(one, n_tri, 0),
                                np.repeat(one, n_tri, 0))
        kb_sph = -(-n_sph // BLOCK)
        nodes = bvh.node_table(sph, tri, kb_sph, 0.0, "cpu")
        assert bvh.depth(nodes.shape[0]) <= stack, (n_sph, n_tri)
        assert int(nodes[1, 6]) == n_sph + n_tri


def _entered(nodes, rows, o, d, idx):
    """(entry, pass) of the kernel's slab test of rays idx into nodes
    rows."""
    inv = []
    for dc in d:
        m = torch.clamp_min(dc.abs(), 1e-12)
        inv.append(1.0 / torch.where(dc >= 0.0, m, -m))
    box = nodes[rows]
    return chip_smoke._slab(box[:, :3], box[:, 3:6], [c[idx] for c in o],
                            [v[idx] for v in inv])


def _chain_entered(nodes, leaf, o, d, idx, limit):
    """Each ray idx enters its leaf and every ancestor before limit."""
    row = leaf.clone()
    while bool((row >= 1).any()):
        tn, ok = _entered(nodes, row, o, d, idx)
        assert bool(ok.all()) and not bool((tn > limit).any())
        row = row // 2
        keep = row >= 1
        row, idx, limit = row[keep], idx[keep], limit[keep]


def test_nearest_hit_leaf_and_ancestors_are_entered_before_the_hit():
    scene = _scene(10_000)
    tab = scene.clusters.tables
    o, d = (_tv(a) for a in _rays(2048, 11))
    gh = dense_nearest(scene.spheres, scene.triangles, o, d)
    hit = torch.nonzero(gh.obj >= 0)[:, 0]
    assert hit.numel() > 500
    pos, ids = _objects(tab)
    where = torch.full((int(ids.max()) + 1,), -1, dtype=torch.int64)
    where[ids.long()] = pos
    leaf = _leaf_of(tab.nodes, where[gh.obj[hit].long()])
    _chain_entered(tab.nodes, leaf, o, d, hit, gh.t[hit])


def test_shadow_blockers_are_entered_before_the_light():
    """Every blocker of a shadow ray before its point light (its tmax),
    and of one toward a directional light, sits in a leaf that the ray
    enters, with each ancestor, no later than tmax."""
    scene = _scene(10_000)
    pack = scene.clusters
    tab = pack.tables
    o_np, d_np = _rays(512, 12)
    d_np = d_np / np.linalg.norm(d_np, axis=1, keepdims=True)
    o, d = _tv(o_np), _tv(d_np)
    tmax = torch.from_numpy(np.random.default_rng(13).uniform(
        0.5, 25.0, 512).astype(np.float32))
    sph, tri = pack_rows(pack)
    pos, ids = _objects(tab)
    where = torch.full((int(ids.max()) + 1,), -1, dtype=torch.int64)
    where[ids.long()] = pos
    h = [c[None] for c in o]
    ld = [c[None] for c in d]
    soo = h[0] * h[0] + h[1] * h[1] + h[2] * h[2]
    od = h[0] * ld[0] + h[1] * ld[1] + h[2] * ld[2]
    seen = 0
    for tm in (tmax, None):
        tm_ = None if tm is None else tm[None]
        for s0 in range(0, sph.shape[0], 1024):  # (objects, rays) blocks
            blk = sph[s0:s0 + 1024]
            hit = sphere_blocks(*(blk[:, i, None] for i in range(4)), *h,
                                *ld, soo, od, tm_)
            obj, idx = torch.nonzero(hit).unbind(1)
            seen += _blockers_entered(tab, where, s0 + obj, idx, o, d, tm)
        t, hit = _tri_t(*(tri[:, i, None] for i in range(9)), *h, *ld)
        if tm is not None:
            hit = hit & (t < tm_)
        obj, idx = torch.nonzero(hit).unbind(1)
        seen += _blockers_entered(tab, where, sph.shape[0] + obj, idx, o, d,
                                  tm)
    assert seen > 200


def _blockers_entered(tab, where, obj, idx, o, d, tmax) -> int:
    """Check that rays idx enter their blocker obj's (ids) leaf and its
    ancestors before tmax (none: any time); returns the pairs checked."""
    if idx.numel():
        leaf = _leaf_of(tab.nodes, where[obj])
        limit = (torch.full((idx.numel(),), float("inf")) if tmax is None
                 else tmax[idx])
        _chain_entered(tab.nodes, leaf, o, d, idx, limit)
    return idx.numel()
