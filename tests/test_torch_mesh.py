"""The many-object tier of the port against the JAX package, on the CPU:
the scene and its cluster pack (byte-equal) and the intersection tests
(``ray_triangle``, the dense tester that is ``cluster_nearest_cuda``'s
plain version, the brute oracle). The fused kernel's
plain version is in tests/test_torch_mesh_fused.py, the routing of
``--scene many`` and ``--renderer`` in tests/test_torch_routing.py.

Inputs come from numpy seeds through both packages. JAX runs eagerly or
jitted on the CPU, never as a Pallas kernel in interpret mode (those
compiles take minutes, tests/test_mesh_fused.py:9-10).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ttrt.mesh.clusters as jclusters
from make_torch_golden import jax_mesh_scene, scene_leaves
from ttrt.kernels.mesh_fused import order_subclusters as jax_order
from ttrt.mesh.dense import dense_nearest as jax_dense_nearest
from ttrt.mesh.scene import trace_ray_mesh_brute as jax_brute
from ttrt.mesh.triangles import floor_mesh_np as jax_floor_mesh_np
from ttrt.mesh.triangles import ray_triangle as jax_ray_triangle
from ttrt.vec import Vec3 as JVec3

from ttrt_torch.kernels import mesh, mesh_fused
from ttrt_torch.mesh import clusters, dense
from ttrt_torch.mesh.scene import (MeshScene, trace_ray_mesh,
                                   trace_ray_mesh_brute)
from ttrt_torch.mesh.triangles import Triangles, floor_mesh_np, ray_triangle
from ttrt_torch.scene import scene_from_numpy
from ttrt_torch.vec import Vec3

torch.set_num_threads(1)  # the test workers share the cores

PACK_FIELDS = ("sph", "sph_lo", "sph_hi", "sph_valid", "tri", "tri_lo",
               "tri_hi", "tri_valid", "sph_lo_q", "sph_hi_q", "tri_lo_q",
               "tri_hi_q")


def _pair(n_spheres, w, h, t=0.9, seed=5, cells=3, procedural="colors",
          dtype=torch.float32):
    """The JAX MeshScene of tests/test_mesh_fused.py and the port's scene
    made from its leaves (with the port's own cluster pack)."""
    js = jax_mesh_scene(t, n_spheres, w, h, seed, cells, procedural)
    ts = scene_from_numpy(scene_leaves(js), procedural, device="cpu",
                          dtype=dtype)
    return js, ts


def _rays(n, seed, dtype=np.float32):
    """Random rays from points around the scene toward random directions
    (unnormalized, as the dense testers allow)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform([-12, -1, -12], [12, 6, 12], (n, 3)).astype(dtype)
    d = rng.normal(size=(n, 3)).astype(dtype)
    d[: n // 4, 1] = -np.abs(d[: n // 4, 1])  # a quarter toward the floor
    return o, d


def _jv(a):
    return JVec3(*(jnp.asarray(a[:, i]) for i in range(3)))


def _tv(a):
    return Vec3(*(torch.from_numpy(np.ascontiguousarray(a[:, i]))
                  for i in range(3)))


# -- scene and pack ----------------------------------------------------------


@pytest.mark.parametrize("cells", [2, 16])
def test_floor_mesh_equals_jax(cells):
    want = jax_floor_mesh_np(y=-2.0, half_extent=20.0, cells=cells)
    got = floor_mesh_np(y=-2.0, half_extent=20.0, cells=cells)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(want[key]), err_msg=key)


@pytest.mark.parametrize("n_spheres,cells", [(200, 3), (2240, 16)])
def test_many_sphere_scene_and_pack_byte_equal_jax(n_spheres, cells):
    """The port's own scene (from the same numpy seed) equals JAX's leaf by
    leaf, and its cluster pack, built by the port's ``pack_clusters``,
    equals JAX's array by array, bit for bit (NaN boxes included)."""
    from ttrt_torch import assets
    from ttrt_torch.mesh.scene import many_sphere_scene

    js = jax_mesh_scene(0.0, n_spheres, 24, 12, 5, cells)
    ts = many_sphere_scene(assets.load_skybox("colors", device="cpu"),
                           n_spheres, 24, 12, seed=5, floor_cells=cells,
                           device="cpu")
    want = scene_leaves(js)
    got = scene_leaves(ts)
    for key in want:
        if key.startswith(("camera.frame", "skybox")):
            continue  # the pose and the sky are the app's, not the scene's
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert ts.clusters.sph.shape[1] >= (4 if n_spheres > 2000 else 1)
    for field in PACK_FIELDS:
        a = np.asarray(getattr(js.clusters, field))
        b = getattr(ts.clusters, field).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, field
        assert a.tobytes() == b.tobytes(), field


def test_pack_from_leaves_equals_pack_from_numpy():
    """The pack that ``scene_from_numpy`` builds from a JAX MeshScene's
    leaves equals JAX's own pack."""
    js, ts = _pair(2240, 16, 8, cells=16)
    assert isinstance(ts, MeshScene) and ts.grid is None
    for field in PACK_FIELDS:
        assert (np.asarray(getattr(js.clusters, field)).tobytes()
                == getattr(ts.clusters, field).numpy().tobytes()), field


def test_order_subclusters_equals_jax():
    js, ts = _pair(2240, 16, 8, cells=16)
    want = np.asarray(jax_order(js.clusters, js.camera.frame.origin))
    got = mesh_fused.order_subclusters(ts.clusters, ts.camera.frame.origin)
    np.testing.assert_array_equal(got.numpy(), want)


# -- intersection ------------------------------------------------------------


def test_ray_triangle_matches_jax():
    """Rays aimed near random triangles' centroids, one triangle each."""
    rng = np.random.default_rng(3)
    o, _ = _rays(512, 4)
    v = rng.uniform(-3, 3, (512, 3, 3)).astype(np.float32)
    e1, e2 = v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]
    aim = v.mean(axis=1) + rng.normal(scale=0.7, size=(512, 3))
    d = (aim - o).astype(np.float32)
    t_j, hit_j = jax_ray_triangle(_jv(o), _jv(d), _jv(v[:, 0]), _jv(e1),
                                  _jv(e2))
    t_t, hit_t = ray_triangle(_tv(o), _tv(d), _tv(v[:, 0]), _tv(e1),
                              _tv(e2))
    hit_j = np.asarray(hit_j)
    assert np.array_equal(hit_t.numpy(), hit_j)
    assert 50 < hit_j.sum() < 500
    np.testing.assert_array_max_ulp(t_t.numpy()[hit_j],
                                    np.asarray(t_j)[hit_j], maxulp=1)


@pytest.mark.parametrize("n_spheres", [200, 2240])
def test_dense_nearest_matches_jax_and_brute(n_spheres):
    """The dense tester (cluster_nearest_cuda's plain version) against JAX's on
    random rays: t to 1 ulp, ids equal; and against the port's brute
    oracle: the same winners."""
    js, ts = _pair(n_spheres, 16, 8, cells=16)
    o, d = _rays(2048, n_spheres)
    gj = jax_dense_nearest(js.spheres, js.triangles, _jv(o), _jv(d))
    gt = dense.dense_nearest(ts.spheres, ts.triangles, _tv(o), _tv(d))
    ids = gt.obj.numpy()
    np.testing.assert_array_equal(ids, np.asarray(gj.obj))
    hit = ids >= 0
    assert hit.sum() > 300 and (ids[hit] >= n_spheres).sum() > 50
    np.testing.assert_array_max_ulp(gt.t.numpy()[hit],
                                    np.asarray(gj.t)[hit], maxulp=1)
    assert np.isinf(gt.t.numpy()[~hit]).all()

    # the brute oracle (reference quadratic) picks the same objects
    bh = trace_ray_mesh_brute(ts, _tv(o), _tv(d), sample_sky=False)
    kind = bh.kind.numpy()
    np.testing.assert_array_equal(kind != 0, hit)
    np.testing.assert_array_equal(kind[hit] == 3, ids[hit] >= n_spheres)
    # and trace_ray_mesh takes the dense tester for CPU rays, no kernel
    before = mesh.cluster_nearest_cuda.launches
    th = trace_ray_mesh(ts, _tv(o), _tv(d), sample_sky=False)
    assert mesh.cluster_nearest_cuda.launches == before
    np.testing.assert_array_equal(th.kind.numpy(), kind)


def test_trace_ray_mesh_brute_matches_jax():
    """The brute oracle's hit records (kind, point, normal, color with the
    sky on misses) against JAX's: kinds equal, the rest to 2 ulp."""
    js, ts = _pair(2240, 16, 8, cells=3)
    o, d = _rays(1024, 8)
    hj = jax_brute(js, _jv(o), _jv(d))
    ht = trace_ray_mesh_brute(ts, _tv(o), _tv(d))
    np.testing.assert_array_equal(ht.kind.numpy(), np.asarray(hj.kind))
    assert (ht.kind.numpy() == 1).sum() > 50
    assert (ht.kind.numpy() == 3).sum() > 20
    for a, b in ((ht.point, hj.point), (ht.normal, hj.normal),
                 (ht.material.color, hj.material.color)):
        for ca, cb in zip(a, b):
            np.testing.assert_array_max_ulp(ca.numpy(), np.asarray(cb),
                                            maxulp=2)


def test_triangles_from_np_round_trip():
    h = Triangles.create_np(np.array([[[0, 0, 0], [1, 0, 0], [0, 0, 1]]]),
                            np.array([[1.0, 0.5, 0.25]]), 0.3)
    tris = Triangles.from_np(h, dtype=torch.float64, device="cpu")
    assert tris.count == 1
    np.testing.assert_array_equal(
        torch.stack(list(tris.normal))[:, 0].numpy(), [0.0, -1.0, 0.0])
    lo, hi = Triangles.aabbs_np(h)
    np.testing.assert_array_equal(lo, [[0, 0, 0]])
    np.testing.assert_array_equal(hi, [[1, 0, 1]])
    assert clusters.BLOCK == jclusters.BLOCK == 128
