"""``chip_smoke.walk_work``, the replay of the many-object kernels' walks,
on the CPU.

``walk_work`` walks the kernel tables' quarters in index order over a ray
batch, with the kernel's slab test, its skip of a quarter entered after
the running best t and the dense tester's narrow tests, and counts the
narrow tests each ray makes and those its warp of 32 rays issues. Its
final hits must be the plain versions' bit for bit (that is what shows
the replay is the kernel's walk), its count can never fall below
``chip_smoke.narrow_work``'s floor, and on a ray whose first entered
quarter holds its hit it equals the floor counted on the boxes it
slab-tests (the kernel tables', widened by BOX_PAD). These tests check
that on a small
pack (a few hundred spheres and a floor), on the primary rays of a frame
and on random rays, against the port's testers and JAX's dense tester.
The replay of the fused kernel's walk of the pack's tree must find the
same hits, and both walks' shadow replays the plain version's blockers.
"""

import numpy as np
import pytest
import torch

from test_torch_mesh import _jv, _pair, _rays, _tv
from ttrt.mesh.dense import dense_nearest as jax_dense_nearest

import chip_smoke
from ttrt_torch.config import RenderConfig
from ttrt_torch.kernels import mesh, mesh_fused
from ttrt_torch.mesh.clusters import pack_rows
from ttrt_torch.mesh.dense import dense_nearest
from ttrt_torch.render.integrator import generate_rays

torch.set_num_threads(1)  # the test workers share the cores

N_SPHERES = 300


def _batch(kind):
    """The JAX and port scenes, and (numpy o, numpy d) of a ray batch: a
    32x16x2 frame's primary rays, or random rays around the scene."""
    js, ts = _pair(N_SPHERES, 32, 16, cells=16)
    if kind == "primary":
        cfg = RenderConfig(width=32, height=16, rays_per_pixel=2)
        o, d = generate_rays(ts, cfg)
        o, d = (np.stack([c.reshape(-1).numpy() for c in v], -1)
                for v in (o, d))
    else:
        o, d = _rays(1024, 7)
    return js, ts, o, d


def _floor(ts, o, d, limit, widened=False) -> int:
    """narrow_work's floor of the rays (o, d) with these nearest t, on the
    quarters as built or (``widened``) on the kernel tables' boxes, which
    BOX_PAD widens and the walk slab-tests."""
    boxes = chip_smoke.quarter_work(ts.clusters)
    if widened:
        qbox = ts.clusters.tables.qbox
        keep = qbox[:, 6] > 0
        boxes = (qbox[keep, :3], qbox[keep, 3:6]) + boxes[2:]
    objs, _ = chip_smoke.narrow_work(boxes, _tv(o), _tv(d), limit)
    return int(objs)


@pytest.mark.parametrize("kind", ["primary", "random"])
def test_walk_hits_equal_the_plain_versions(kind):
    js, ts, o, d = _batch(kind)
    walk = chip_smoke.walk_work(ts.clusters, _tv(o), _tv(d))
    plain = mesh.cluster_nearest_plain(ts.clusters, _tv(o), _tv(d))
    dense = dense_nearest(ts.spheres, ts.triangles, _tv(o), _tv(d))
    for ref in (plain, dense):
        assert torch.equal(walk["hit"].t, ref.t)
        assert torch.equal(walk["hit"].obj, ref.obj.to(torch.int32))
    ids = walk["hit"].obj.numpy()
    hit = ids >= 0
    assert hit.sum() > 100 and (ids[hit] >= N_SPHERES).sum() > 10
    gj = jax_dense_nearest(js.spheres, js.triangles, _jv(o), _jv(d))
    np.testing.assert_array_equal(ids, np.asarray(gj.obj))
    np.testing.assert_array_max_ulp(walk["hit"].t.numpy()[hit],
                                    np.asarray(gj.t)[hit], maxulp=1)


@pytest.mark.parametrize("kind", ["primary", "random"])
def test_walk_makes_at_least_the_floor(kind):
    """Every ray's narrow tests are at least its floor: the walk's boxes
    are the floor's widened, and its best t never falls below the final
    hit."""
    _, ts, o, d = _batch(kind)
    walk = chip_smoke.walk_work(ts.clusters, _tv(o), _tv(d))
    t = walk["hit"].t
    tests = walk["tests"].numpy()
    assert walk["lane_tests"] == int(tests.sum())
    assert walk["lane_tests"] >= _floor(ts, o, d, t)
    for i in range(0, len(o), 37):
        assert tests[i] >= _floor(ts, o[i:i + 1], d[i:i + 1], t[i:i + 1])


def _quarter_of(tables, ids):
    """The box-table row of the quarter that holds each object id."""
    rows = {}
    for pos, i in enumerate(tables.sph_id.tolist()):
        rows[i] = (pos // 128) * 4 + (pos % 128) // 32
    for pos, i in enumerate(tables.tri_id.tolist()):
        rows[i] = (tables.kb_sph + pos // 128) * 4 + (pos % 128) // 32
    return np.array([rows.get(int(i), -2) for i in ids])


@pytest.mark.parametrize("kind", ["primary", "random"])
def test_walk_meets_the_floor_when_its_first_quarter_holds_the_hit(kind):
    """A ray whose hit lies in the first quarter it narrow-tests: from
    there on its best t is final, so it tests exactly the quarters whose
    boxes it enters before its hit, the floor counted on the boxes it
    slab-tests (the kernel tables', widened), and at least the floor on
    the boxes as built."""
    _, ts, o, d = _batch(kind)
    walk = chip_smoke.walk_work(ts.clusters, _tv(o), _tv(d))
    tests = walk["tests"].numpy()
    t = walk["hit"].t
    ids = walk["hit"].obj.numpy()
    held = np.nonzero((ids >= 0) & (_quarter_of(ts.clusters.tables, ids)
                                    == walk["first"].numpy()))[0]
    assert held.size >= 4
    for i in held:
        one = (o[i:i + 1], d[i:i + 1], t[i:i + 1])
        assert _floor(ts, *one, widened=True) == tests[i]
        assert _floor(ts, *one) <= tests[i]


def test_walk_simt_efficiency():
    """A warp of 32 copies of one ray issues exactly its lanes' tests
    (efficiency 1); on a mixed batch a warp issues at least what its
    busiest lane tests, so the efficiency lies in (0, 1]."""
    _, ts, o, d = _batch("random")
    same = chip_smoke.walk_work(ts.clusters, _tv(np.repeat(o[:1], 32, 0)),
                                _tv(np.repeat(d[:1], 32, 0)))
    assert same["lane_tests"] > 0 and same["simt"] == 1.0
    assert same["warp_tests"] * 32 == same["lane_tests"]
    walk = chip_smoke.walk_work(ts.clusters, _tv(o), _tv(d))
    per_warp = walk["tests"].numpy().reshape(-1, 32)
    assert walk["warp_tests"] >= int(per_warp.max(1).sum())
    assert 0.0 < walk["simt"] <= 1.0
    assert walk["simt"] == walk["lane_tests"] / (32 * walk["warp_tests"])


@pytest.mark.parametrize("kind", ["primary", "random"])
def test_tree_walk_hits_equal_the_plain_versions(kind):
    """The replay of the fused kernel's tree walk finds the dense tester's
    hits bit for bit, with fewer narrow tests than the flat sweep, and
    every ray slab-tests the root."""
    _, ts, o, d = _batch(kind)
    tree = chip_smoke.walk_work(ts.clusters, _tv(o), _tv(d), tree=True)
    flat = chip_smoke.walk_work(ts.clusters, _tv(o), _tv(d))
    dense = dense_nearest(ts.spheres, ts.triangles, _tv(o), _tv(d))
    assert torch.equal(tree["hit"].t, dense.t)
    assert torch.equal(tree["hit"].obj, dense.obj.to(torch.int32))
    assert tree["lane_tests"] < flat["lane_tests"]
    assert tree["first"] is None and 0.0 < tree["slab_simt"] <= 1.0
    assert tree["lane_slabs"] == int(tree["slabs"].sum())
    assert bool((tree["slabs"] >= 1).all())


@pytest.mark.parametrize("tree", [False, True])
def test_shadow_walks_find_the_plain_blockers(tree):
    """Both walks' shadow replays (any-hit along unit directions, stopping
    at the first blocker) block exactly the rays the plain version's
    shadow test blocks, toward a point light (tmax) and a directional
    one."""
    _, ts, o, d = _batch("random")
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    tmax = torch.from_numpy(np.random.default_rng(3).uniform(
        0.5, 20.0, len(o)).astype(np.float32))
    sph, tri = pack_rows(ts.clusters)
    od, dd = _tv(o), _tv(d)
    for tm in (tmax, None):
        want = mesh_fused._shadow_blocked(sph[:, :4], tri[:, :9], *od, *dd,
                                          tm)
        walk = chip_smoke.walk_work(ts.clusters, od, dd, tree=tree,
                                    shadow=True, tmax=tm)
        assert torch.equal(walk["blocked"], want)
        assert int(want.sum()) > 50
        assert walk["lane_tests"] >= int(want.sum())
