"""The port's uniform grid (``ttrt_torch.mesh.grid``) and the CPU route
of ``trace_ray_mesh`` against the JAX package: the grid build bit for bit,
the 3D-DDA walk against JAX's walk in float64 and against the port's
brute oracle, ``MeshScene.with_spheres``, and a float64 frame rendered
through the grid against JAX ``render_frame``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from make_torch_golden import scene_leaves
from ttrt.assets import make_colors_skybox, skybox_from_faces
from ttrt.config import RenderConfig as JaxRenderConfig
from ttrt.frames import orbit_camera_frame as jax_orbit
from ttrt.mesh import many_sphere_scene as jax_many_sphere_scene
from ttrt.mesh.grid import traverse_grid as jax_traverse_grid
from ttrt.render.integrator import render_frame as jax_render_frame
from ttrt.vec import Vec3 as JVec3

from ttrt_torch import assets
from ttrt_torch.config import RenderConfig
from ttrt_torch.mesh import clusters
from ttrt_torch.mesh import scene as mesh_scene
from ttrt_torch.mesh.grid import build_grid, grid_from_numpy, traverse_grid
from ttrt_torch.mesh.scene import (many_sphere_scene, trace_ray_mesh,
                                   trace_ray_mesh_brute)
from ttrt_torch.render import integrator
from ttrt_torch.scene import HIT_SPHERE, HIT_TRIANGLE, scene_from_numpy
from ttrt_torch.vec import Vec3

torch.set_num_threads(1)  # the test workers share the cores

TORCH_OF = {jnp.float32: torch.float32, jnp.float64: torch.float64}


def _jax_scene(n=200, seed=3, dtype=jnp.float32, **kw):
    """tests/test_mesh.py's random many-object scene."""
    sky = skybox_from_faces(make_colors_skybox(16), dtype)
    kw = {"width_px": 32, "height_px": 16, "floor_cells": 4, **kw}
    return jax_many_sphere_scene(sky, n_spheres=n, seed=seed, dtype=dtype,
                                 **kw)


def _port_scene(n=200, seed=3, dtype=torch.float32, **kw):
    kw = {"width_px": 32, "height_px": 16, "floor_cells": 4, **kw}
    return many_sphere_scene(assets.load_skybox("colors", device="cpu"), n,
                             seed=seed, dtype=dtype, device="cpu", **kw)


def _carried(js, dtype):
    """The port's scene from JAX's leaves with JAX's grid carried across."""
    g = js.grid
    return scene_from_numpy(scene_leaves(js), "colors", device="cpu",
                            dtype=dtype)._replace(grid=grid_from_numpy(
                                np.asarray(g.cells),
                                [np.asarray(c) for c in g.origin],
                                [np.asarray(c) for c in g.cell_size],
                                dtype=dtype, device="cpu"))


def _rays(js, seed=20260816, n_rays=512, dtype=np.float32):
    """tests/test_mesh.py:99-115's rays: origins above the floor, the last
    64 aimed at random sphere centers, normalized in float64."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-18, 18, (n_rays, 3))
    o[:, 1] = np.abs(o[:, 1]) + 0.5
    d = rng.normal(size=(n_rays, 3))
    centers = np.stack([np.asarray(v, np.float64) for v in js.spheres.center],
                       -1)
    pick = rng.integers(0, centers.shape[0], 64)
    d[-64:] = centers[pick] - o[-64:]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(dtype), d.astype(dtype)


def _jv(a):
    return JVec3(*(jnp.asarray(a[:, i]) for i in range(3)))


def _tv(a):
    return Vec3(*(torch.from_numpy(np.ascontiguousarray(a[:, i]))
                  for i in range(3)))


def _assert_grid_equal(got, want):
    np.testing.assert_array_equal(got.cells.numpy(), np.asarray(want.cells))
    for g, w in (*zip(got.origin, want.origin),
                 *zip(got.cell_size, want.cell_size)):
        assert g.numpy().tobytes() == np.asarray(w).tobytes()


@pytest.mark.parametrize("jdtype", [jnp.float32, jnp.float64])
def test_build_grid_equals_jax(jdtype):
    js = _jax_scene(dtype=jdtype)
    ts = _port_scene(dtype=TORCH_OF[jdtype])
    assert ts.grid.dims == js.grid.dims
    _assert_grid_equal(ts.grid, js.grid)
    # the same grid from the tensors, without the host arrays
    _assert_grid_equal(build_grid(ts.spheres, ts.triangles,
                                  dtype=TORCH_OF[jdtype], device="cpu"),
                       js.grid)


def test_explicit_resolution_equals_jax():
    """tests/test_mesh.py:208-214."""
    sky = skybox_from_faces(make_colors_skybox(8), jnp.float32)
    js = jax_many_sphere_scene(sky, n_spheres=10, width_px=8, height_px=8,
                               grid_resolution=(4, 2, 4), floor_cells=2)
    ts = many_sphere_scene(assets.load_skybox("colors", device="cpu"), 10, 8,
                           8, device="cpu", grid_resolution=(4, 2, 4),
                           floor_cells=2)
    assert ts.grid.dims == (4, 2, 4)
    _assert_grid_equal(ts.grid, js.grid)


def test_every_object_is_in_some_cell():
    ts = _port_scene(n=50)
    cells = ts.grid.cells.numpy()
    present = set(cells[cells >= 0].tolist())
    assert present == set(range(ts.spheres.count + ts.triangles.count))
    for row in cells.reshape(-1, ts.grid.capacity):
        ids = row[row >= 0]
        assert (np.diff(ids) > 0).all() and (row[len(ids):] == -1).all()


def test_traverse_grid_equals_jax_f64():
    """JAX's walk and the port's on the same float64 grid and rays: every
    id equal, t within 1e-9."""
    js = _jax_scene(dtype=jnp.float64)
    ts = _carried(js, torch.float64)
    o, d = _rays(js, dtype=np.float64)
    want = jax.jit(jax_traverse_grid)(js.grid, js.spheres, js.triangles,
                                      _jv(o), _jv(d))
    got = traverse_grid(ts.grid, ts.spheres, ts.triangles, _tv(o), _tv(d))
    np.testing.assert_array_equal(got.obj.numpy(), np.asarray(want.obj))
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=0,
                               atol=1e-9)
    ids = got.obj.numpy()
    assert (ids >= 0).sum() > 100 and (ids < ts.spheres.count).any()


def test_trace_through_the_grid_equals_jax_f64(monkeypatch):
    """``trace_ray_mesh`` on CPU rays takes the grid (the dense tester is
    not called): kinds equal to JAX's grid trace, point within 1e-9."""
    from ttrt.mesh.scene import trace_ray_mesh as jax_trace

    js = _jax_scene(dtype=jnp.float64)
    ts = _carried(js, torch.float64)
    o, d = _rays(js, dtype=np.float64)

    def refuse(*a, **kw):
        raise AssertionError("the dense tester ran")

    monkeypatch.setattr(mesh_scene, "dense_nearest", refuse)
    hit = trace_ray_mesh(ts, _tv(o), _tv(d), sample_sky=False)
    want = jax.jit(lambda s, o, d: jax_trace(s, o, d, sample_sky=False))(
        js, _jv(o), _jv(d))
    np.testing.assert_array_equal(hit.kind.numpy(), np.asarray(want.kind))
    for a, b in (*zip(hit.point, want.point), *zip(hit.normal, want.normal)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-9)


def test_grid_matches_brute_force():
    """tests/test_mesh.py:99-143 on the port: the grid against the port's
    brute oracle in float32, kinds equal, atol 1e-4."""
    ts = _port_scene()
    o, d = _rays(_jax_scene())
    hit_g = trace_ray_mesh(ts, _tv(o), _tv(d), sample_sky=False)
    hit_b = trace_ray_mesh_brute(ts, _tv(o), _tv(d), sample_sky=False)
    np.testing.assert_array_equal(hit_g.kind.numpy(), hit_b.kind.numpy())
    for a, b in (*zip(hit_g.point, hit_b.point),
                 *zip(hit_g.normal, hit_b.normal)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4)
    np.testing.assert_allclose(hit_g.material.reflectivity.numpy(),
                               hit_b.material.reflectivity.numpy(), atol=1e-6)
    kinds = set(hit_g.kind.numpy().tolist())
    assert HIT_SPHERE in kinds and HIT_TRIANGLE in kinds


def test_with_spheres_drops_the_grid_and_rebuilds_the_pack():
    """tests/test_mesh.py:144-183 on the port: moved spheres drop the
    grid, CPU rays take the dense tester and equal the brute oracle; the
    cluster pack is rebuilt, equal to a fresh pack of the moved spheres."""
    ts = _port_scene(n=64)
    sph = ts.spheres
    moved = sph._replace(center=Vec3(sph.center.x + 7.5, sph.center.y + 3.0,
                                     sph.center.z - 6.0))
    ts2 = ts.with_spheres(moved)
    assert ts2.grid is None and ts2.spheres is moved
    fresh = clusters.pack_clusters(moved, ts.triangles)
    for got, want in ((ts2.clusters, fresh),
                      (ts2.clusters.tables, fresh.tables)):
        for a, b in zip(got, want):
            if isinstance(a, torch.Tensor):
                assert a.dtype == b.dtype
                assert a.numpy().tobytes() == b.numpy().tobytes()
            elif not hasattr(a, "_fields"):
                assert a == b
    assert not torch.equal(ts2.clusters.sph, ts.clusters.sph)

    rng = np.random.default_rng(7)
    o = rng.uniform(-18, 18, (256, 3)).astype(np.float32)
    o[:, 1] = np.abs(o[:, 1]) + 0.5
    d = rng.normal(size=(256, 3)).astype(np.float32)
    # the last 32 aimed at moved spheres: the sphere branch must run
    centers = np.stack([c.numpy() for c in moved.center], -1)
    d[-32:] = centers[rng.integers(0, 64, 32)] - o[-32:]
    od, dd = _tv(o), _tv(d).normalize()
    hit = trace_ray_mesh(ts2, od, dd, sample_sky=False)
    hit_b = trace_ray_mesh_brute(ts2, od, dd, sample_sky=False)
    np.testing.assert_array_equal(hit.kind.numpy(), hit_b.kind.numpy())
    for a, b in zip(hit.point, hit_b.point):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-3,
                                   rtol=2e-4)
    assert HIT_SPHERE in set(hit.kind.numpy().tolist())


def test_render_frame_through_the_grid_matches_jax_f64(monkeypatch):
    """tests/test_torch_integrator.py's many-object frame (200 spheres,
    24x12, 2 spp, 3 bounces) through the port's own grid: within that
    file's float64 bar of JAX ``render_frame`` (JAX's grid), equal traces."""
    w, h = 24, 12
    sky = skybox_from_faces(make_colors_skybox(16), jnp.float64,
                            procedural="colors")
    js = jax_many_sphere_scene(sky, n_spheres=200, width_px=w, height_px=h,
                               seed=5, dtype=jnp.float64, floor_cells=3)
    js = js.with_camera_frame(jax.tree.map(lambda a: a.astype(jnp.float64),
                                           jax_orbit(0.9, jnp.float64)))
    ts = scene_from_numpy(scene_leaves(js), "colors", device="cpu",
                          dtype=torch.float64)
    ts = ts._replace(grid=build_grid(ts.spheres, ts.triangles,
                                     dtype=torch.float64, device="cpu"))
    _assert_grid_equal(ts.grid, js.grid)
    jcfg = JaxRenderConfig(width=w, height=h, rays_per_pixel=2,
                           bounce_limit=3, dtype=jnp.float64)
    cfg = RenderConfig(width=w, height=h, rays_per_pixel=2, bounce_limit=3,
                       dtype=torch.float64)

    def refuse(*a, **kw):
        raise AssertionError("the dense tester ran")

    monkeypatch.setattr(mesh_scene, "dense_nearest", refuse)
    fb, rays = integrator.render_frame(ts, cfg, count_rays=True)
    fb_ref, rays_ref = jax_render_frame(js, jcfg, count_rays=True)
    ref = np.asarray(fb_ref.to_array(), np.float64)
    out = fb.to_array().numpy()
    assert float(np.abs(ref - out).max()) <= 1e-9
    assert int(rays) == int(rays_ref)
