"""The objects axis of the port (``ttrt_torch.parallel.objects``) and the
plain version of ``cluster_nearest`` (``kernels/mesh.py``), on the CPU: the
padded shards against JAX's ``pad_pack_subclusters``, every shard's
nearest hit merged against the whole pack's, and a 1x1x2 world of two
spawned gloo ranks.

Tolerances: none. The plain ``cluster_nearest`` repeats the dense
tester's arithmetic on the pack's own tables (t bit for bit, ids equal);
the argmin by t is exact, so a sharded trace equals the whole pack's and
the objects-sharded frame equals the unsharded eager integrator's, bit for
bit.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
import torch_ranks
from make_torch_golden import jax_mesh_scene, scene_leaves
from ttrt.parallel.objects import pad_pack_subclusters as jax_pad

from ttrt_torch import assets
from ttrt_torch.config import ConfigError, RenderConfig
from ttrt_torch.kernels import mesh
from ttrt_torch.mesh.clusters import QUARTERS, _morton_rows
from ttrt_torch.mesh.dense import NearestHit, dense_nearest
from ttrt_torch.mesh.scene import many_sphere_scene
from ttrt_torch.parallel import objects
from ttrt_torch.render import integrator
from ttrt_torch.scene import scene_from_numpy
from ttrt_torch.vec import Vec3

torch.set_num_threads(1)  # the test workers share the cores

REPO = Path(__file__).resolve().parent.parent
W, H, N, B = 16, 8, 2, 3
MANY = 300
INF = np.float32(np.inf)
# hand-made per-rank nearest hits: ties in t, misses, one-sided misses
HAND_T = [np.array([1.0, 2.0, INF, 3.0, 5.0, INF], np.float32),
          np.array([1.0, 1.5, INF, 3.0, INF, 0.5], np.float32)]
HAND_ID = [np.array([4, 9, -1, 7, 2, -1], np.int32),
           np.array([2, 11, -1, 5, -1, 3], np.int32)]
HAND_WANT = (np.array([1.0, 1.5, INF, 3.0, 5.0, 0.5], np.float32),
             np.array([2, 11, -1, 5, 2, 3], np.int32))
TIE_IDS = np.array([5, 2])


def _scene(n_spheres=MANY, cells=16):
    js = jax_mesh_scene(0.9, n_spheres, W, H, 0, cells)
    ts = scene_from_numpy(scene_leaves(js), "colors", device="cpu",
                          dtype=torch.float32)
    return js, ts


def _frame_rays(ts):
    cfg = RenderConfig(width=W, height=H, rays_per_pixel=N, bounce_limit=B)
    return integrator.generate_rays(ts, cfg)


def _valid(tables):
    """(spheres', triangles') per-subcluster flags: 1 where a subcluster
    holds an object (the quarters' counts, ``qbox[:, 6]``)."""
    n = tables.qbox[:, 6].reshape(-1, QUARTERS).sum(-1) > 0
    return (n[:tables.kb_sph].to(torch.int32).numpy(),
            n[tables.kb_sph:].to(torch.int32).numpy())


@pytest.mark.parametrize("n", [2, 3])
def test_pad_pack_subclusters_matches_jax(n):
    """The padded ids and valid flags, the port's kernel tables against
    JAX's padded ClusterPack (objects.py:73)."""
    js, ts = _scene(MANY, cells=3)
    want = jax_pad(js.clusters, n)
    got = objects.pad_pack_subclusters(ts.clusters.tables, n)
    assert got.kb_sph % n == 0 and got.kb_tri % n == 0
    # the tree's leaves number the triangles from the unpadded kb_sph, so
    # padded tables drop it
    tables = ts.clusters.tables
    padded = (got.kb_sph, got.kb_tri) != (tables.kb_sph, tables.kb_tri)
    assert tables.nodes is not None and (got.nodes is None) == padded
    assert (got.kb_sph, got.kb_tri) == (want.sph_lo.shape[0],
                                        want.tri_lo.shape[0])
    for ids, table, row in ((got.sph_id, want.sph, 4),
                            (got.tri_id, want.tri, 9)):
        rows = _morton_rows(torch.as_tensor(np.array(table)))[:, row]
        np.testing.assert_array_equal(ids.numpy(), rows.numpy())
    sv, tv = _valid(got)
    np.testing.assert_array_equal(sv, np.asarray(want.sph_valid))
    np.testing.assert_array_equal(tv, np.asarray(want.tri_valid))
    assert objects.pad_pack_subclusters(got, n) is got


def test_shards_partition_the_pack():
    """Shards cut the padded tables into equal runs of subclusters, the
    sphere quarter boxes of a shard before its triangles'."""
    _, ts = _scene()
    tables = ts.clusters.tables
    for n in (2, 4):
        padded = objects.pad_pack_subclusters(tables, n)
        shards = [objects.shard_tables(padded, n, k) for k in range(n)]
        for key in ("sph_id", "tri_id", "sph", "tri"):
            np.testing.assert_array_equal(
                torch.cat([getattr(s, key) for s in shards]).numpy(),
                getattr(padded, key).numpy())
        qs = padded.kb_sph * QUARTERS
        np.testing.assert_array_equal(
            torch.cat([s.qbox[:s.kb_sph * QUARTERS] for s in shards]
                      + [s.qbox[s.kb_sph * QUARTERS:] for s in shards]
                      ).numpy(),
            torch.cat([padded.qbox[:qs], padded.qbox[qs:]]).numpy())
    with pytest.raises(ValueError, match="pad them first"):
        objects.shard_tables(tables, 7, 0)


def test_cluster_nearest_plain_equals_dense_tester():
    """The plain version of the kernel, on the pack's tables, against the
    dense tester on the raw geometry: t bit for bit, ids equal."""
    _, ts = _scene()
    o, d = _frame_rays(ts)
    before = (mesh.cluster_nearest_plain.launches,
              mesh.cluster_nearest_cuda.launches)
    got = mesh.cluster_nearest(ts.clusters, o, d)
    assert (mesh.cluster_nearest_plain.launches,
            mesh.cluster_nearest_cuda.launches) == (before[0] + 1, before[1])
    stats = chip_smoke.nearest_bar(
        dense_nearest(ts.spheres, ts.triangles, o, d), got)
    assert stats["hits"] > 0
    with pytest.raises(ConfigError, match="float32"):
        mesh.cluster_nearest_plain(ts.clusters, Vec3(*(c.double() for c in o)),
                                   d)


def test_sharded_nearest_equals_whole_pack():
    """chip_smoke.py phase M4 on the CPU: every shard's nearest hit, merged
    by the argmin by t, equals the whole pack's, on 2 and 4 shards."""
    _, ts = _scene()
    o, d = _frame_rays(ts)
    whole = mesh.cluster_nearest_plain(ts.clusters, o, d)
    for n in (2, 4):
        padded = objects.pad_pack_subclusters(ts.clusters.tables, n)
        hits = [mesh.cluster_nearest_plain(
            objects.shard_tables(padded, n, k), o, d) for k in range(n)]
        chip_smoke.nearest_bar(whole, objects.merge_nearest(hits))


def test_merge_nearest_hand_made():
    hits = [NearestHit(torch.from_numpy(t), torch.from_numpy(i))
            for t, i in zip(HAND_T, HAND_ID)]
    got = objects.merge_nearest(hits)
    np.testing.assert_array_equal(got.t.numpy(), HAND_WANT[0])
    np.testing.assert_array_equal(got.obj.numpy(), HAND_WANT[1])
    assert got.obj.dtype == torch.int32


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The two ranks' results of ``torch_ranks.objects_world``."""
    tmp = tmp_path_factory.mktemp("world_1x1x2")
    rng = np.random.default_rng(21)
    d = np.stack([rng.uniform(-0.05, 0.05, 64), rng.uniform(-0.05, 0.05, 64),
                  np.ones(64)]).astype(np.float32)
    np.savez(tmp / "inputs.npz", config=np.array([W, H, N, B]),
             t0=HAND_T[0], t1=HAND_T[1], id0=HAND_ID[0], id1=HAND_ID[1],
             tie_ids=TIE_IDS, tie_center=np.array([0.0, 0.0, 5.0],
                                                  np.float32),
             tie_o=np.zeros((3, 64), np.float32), tie_d=d)
    return torch_ranks.run_world(torch_ranks.objects_world, 2, tmp, MANY)


def test_objects_sharded_frame_equals_unsharded_integrator(world):
    cfg = RenderConfig(width=W, height=H, rays_per_pixel=N, bounce_limit=B)
    # without its grid the CPU trace is the dense tester, whose bits the
    # shards' cluster_nearest_plain repeats (the grid's walk uses the
    # reference quadratic)
    scene = many_sphere_scene(assets.load_skybox("colors", device="cpu"),
                              MANY, W, H, device="cpu")._replace(grid=None)
    fb, rays = integrator.render_frame(scene, cfg, count_rays=True)
    want = fb.to_array().numpy()
    assert want.std() > 0
    for r in world:
        np.testing.assert_array_equal(r["frame"], want)
        assert r["rays"] == int(rays)


def test_combine_nearest_on_hand_made_pairs(world):
    for r in world:
        np.testing.assert_array_equal(r["hand"][0], HAND_WANT[0])
        np.testing.assert_array_equal(r["hand"][1], HAND_WANT[1])


def test_exact_tie_across_shards_goes_to_the_lowest_id(world):
    """Both shards hold the same sphere under ids 5 and 2: each finds the
    same t, and the combine keeps id 2 on every hit."""
    t0, id0 = world[0]["tie_local"]
    t1, id1 = world[1]["tie_local"]
    hit = id0 >= 0
    assert hit.sum() > 32
    np.testing.assert_array_equal(t0, t1)
    assert (id0[hit] == 5).all() and (id1[hit] == 2).all()
    for r in world:
        t, ids = r["tie"]
        np.testing.assert_array_equal(t, t0)
        np.testing.assert_array_equal(ids, np.where(hit, 2, -1))


def test_cli_objects_mesh_on_one_rank():
    w, h, frames = 16, 8, 2
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "ttrt_torch", "--device", "cpu", "--mesh",
         "1x1x1", "--scene", "many", "--n-spheres", "200", "--width", str(w),
         "--height", str(h), "--spp", "2", "--bounces", "3", "--frames",
         str(frames), "--no-input"], cwd=REPO, env=env, capture_output=True,
        timeout=180)
    assert proc.returncode == 0, proc.stderr.decode()
    chip_smoke.validate_stream(proc.stdout, w, h, frames)
