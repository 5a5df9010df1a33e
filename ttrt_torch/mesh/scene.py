"""Many-object scene: spheres and a triangle mesh (port of
``ttrt.mesh.scene``), BASELINE config 4: "10k spheres + triangle-mesh
floor". The scene keeps the demo's lights, camera and sky, so the shared
integrator and lighting run unchanged; only the trace differs (registered
with ``render.dispatch``).

``trace_ray_mesh`` routes by the device of the rays: CPU tensors go
through the scene's uniform grid (``mesh.grid.traverse_grid``), or without
one through the dense tester ``mesh.dense.dense_nearest``; CUDA tensors go
to the CUDA kernel ``kernels.mesh.cluster_nearest_cuda``, which needs the
scene's cluster pack and float32 rays.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ttrt_torch.config import ConfigError, constants
from ttrt_torch.mesh.clusters import ClusterPack, pack_clusters
from ttrt_torch.mesh.dense import NearestHit, dense_nearest
from ttrt_torch.mesh.grid import UniformGrid, build_grid, traverse_grid
from ttrt_torch.mesh.triangles import Triangles, floor_mesh_np, ray_triangle
from ttrt_torch.render import dispatch
from ttrt_torch.render.intersect import Hit, ray_sphere_t0
from ttrt_torch.render.skybox import sample_skybox
from ttrt_torch.scene import (HIT_NONE, HIT_SPHERE, HIT_TRIANGLE, Camera,
                              DirectionalLights, Materials, PointLights,
                              Skybox, Spheres)
from ttrt_torch.utils.profiling import SETUP, touch_device
from ttrt_torch.vec import Vec3, scalar_like


class MeshScene(NamedTuple):
    """Root aggregate of the many-object tier."""

    spheres: Spheres
    triangles: Triangles
    grid: Optional[UniformGrid]  # None: CPU rays take the dense tester
    directional_lights: DirectionalLights
    point_lights: PointLights
    camera: Camera
    skybox: Skybox
    clusters: Optional[ClusterPack] = None  # None: no kernel takes it

    def with_camera_frame(self, frame) -> "MeshScene":
        return self._replace(camera=self.camera._replace(frame=frame))

    def with_spheres(self, spheres: Spheres) -> "MeshScene":
        """The scene with its spheres moved (the physics tier's use). The
        grid would be stale, so it is dropped, as JAX drops it, and CPU
        rays take the dense tester. The cluster pack is rebuilt from the
        moved spheres: the card traces a MeshScene only through its pack
        (JAX drops the pack too and traces densely)."""
        return self._replace(spheres=spheres, grid=None,
                             clusters=pack_clusters(spheres, self.triangles))


def trace_ray_mesh(scene: MeshScene, o: Vec3, d: Vec3, *,
                   sample_sky: bool = True, bilinear: bool = False) -> Hit:
    """Nearest-hit trace returning the demo trace's ``Hit`` contract (miss
    fixups, EPSILON back-offset, guarded normalize,
    TerminalRayTracer.c:858-886): for CPU rays the grid's walk, or the
    dense tester in a scene without a grid; the cluster-culled CUDA kernel
    for rays on the card (which raises without a cluster pack or on
    non-float32 rays)."""
    if o.x.device.type == "cpu" and scene.grid is not None:
        gh = traverse_grid(scene.grid, scene.spheres, scene.triangles, o, d)
    elif o.x.device.type == "cpu":
        gh = dense_nearest(scene.spheres, scene.triangles, o, d)
    else:
        from ttrt_torch.kernels.mesh import cluster_nearest_cuda

        if scene.clusters is None:
            raise ConfigError("tracing a MeshScene on the card needs its "
                              "cluster pack")
        gh = cluster_nearest_cuda(scene.clusters, o, d)
    return _finish_hit(scene, o, d, gh, sample_sky, bilinear)


def trace_ray_mesh_dense(scene: MeshScene, o: Vec3, d: Vec3, *,
                         sample_sky: bool = True,
                         bilinear: bool = False) -> Hit:
    """``trace_ray_mesh`` through the dense tester on the rays' device,
    whatever grid or pack the scene carries: the JAX package's trace of a
    pack-less scene on an accelerator, which the bench times as its
    ``mrays_10k_dense_corrected``."""
    gh = dense_nearest(scene.spheres, scene.triangles, o, d)
    return _finish_hit(scene, o, d, gh, sample_sky, bilinear)


def trace_ray_mesh_brute(scene: MeshScene, o: Vec3, d: Vec3, *,
                         sample_sky: bool = True,
                         bilinear: bool = False) -> Hit:
    """Test oracle: every (object, ray) pair in one broadcast block with
    the reference's quadratic (``ray_sphere_t0``) and ``ray_triangle``;
    the first minimum is the lowest id, and a triangle replaces a sphere
    only on a strictly smaller t."""
    shape = o.x.shape
    best_t = torch.full(shape, torch.inf, dtype=o.x.dtype, device=o.x.device)
    best_obj = torch.full(shape, -1, dtype=torch.int32, device=o.x.device)
    n_spheres = scene.spheres.count
    ob = Vec3(*(c[None] for c in o))
    db = Vec3(*(c[None] for c in d))
    col = lambda v: v.reshape((-1,) + (1,) * len(shape))  # noqa: E731
    colv = lambda v: Vec3(*(col(c) for c in v))  # noqa: E731
    if n_spheres:
        t0, hit = ray_sphere_t0(ob, db, colv(scene.spheres.center),
                                col(scene.spheres.radius))
        t0 = torch.where(hit, t0, torch.inf)
        best_t, arg = torch.min(t0, dim=0)
        best_obj = torch.where(torch.isfinite(best_t), arg.to(torch.int32),
                               -1)
    if scene.triangles.count:
        tr = scene.triangles
        tt, hit = ray_triangle(ob, db, colv(tr.v0), colv(tr.e1), colv(tr.e2))
        tt = torch.where(hit, tt, torch.inf)
        tri_t, arg = torch.min(tt, dim=0)
        take = tri_t < best_t
        best_t = torch.where(take, tri_t, best_t)
        best_obj = torch.where(take, arg.to(torch.int32) + n_spheres,
                               best_obj)
    return _finish_hit(scene, o, d, NearestHit(best_t, best_obj), sample_sky,
                       bilinear)


def _finish_hit(scene, o: Vec3, d: Vec3, gh: NearestHit, sample_sky: bool,
                bilinear: bool) -> Hit:
    """The hit record from a (t, obj) result: attribute gathers by the
    winning id, then trace_ray's fixups."""
    n_spheres = scene.spheres.count
    hit_any = gh.obj >= 0
    is_tri = gh.obj >= n_spheres
    t = torch.where(hit_any, gh.t, 0.0)
    point = Vec3(o.x + t * d.x, o.y + t * d.y, o.z + t * d.z)
    sidx = torch.clamp(gh.obj, 0, max(n_spheres - 1, 0)).long()
    tidx = torch.clamp(gh.obj - n_spheres, 0,
                       max(scene.triangles.count - 1, 0)).long()
    s_center = Vec3(*(c[sidx] for c in scene.spheres.center))
    t_normal = Vec3(*(c[tidx] for c in scene.triangles.normal))
    normal_raw = t_normal.where(is_tri, point - s_center)
    s_mat = scene.spheres.material.take(sidx)
    t_mat = scene.triangles.material.take(tidx)
    color = t_mat.color.where(is_tri, s_mat.color)
    refl = torch.where(is_tri, t_mat.reflectivity, s_mat.reflectivity)
    spec = torch.where(is_tri, t_mat.specularity, s_mat.specularity)
    to_origin = (o - point).normalize()
    eps = scalar_like(constants.EPSILON, o.x)
    point_off = Vec3(point.x + to_origin.x * eps,
                     point.y + to_origin.y * eps,
                     point.z + to_origin.z * eps)
    if sample_sky:
        color = color.where(hit_any,
                            sample_skybox(scene.skybox, d, bilinear=bilinear))
    kind = torch.where(hit_any,
                       torch.where(is_tri, HIT_TRIANGLE, HIT_SPHERE),
                       HIT_NONE).to(torch.int32)
    return Hit(kind, point_off.where(hit_any, o),
               normal_raw.where(hit_any, d).normalize(),
               Materials(color, torch.where(hit_any, refl, 0.0),
                         torch.where(hit_any, spec, 0.0)))


dispatch.register_trace(MeshScene, trace_ray_mesh)


def many_sphere_scene(skybox: Skybox, n_spheres: int = 10_000,
                      width_px: int = 480, height_px: int = 280,
                      seed: int = 0, *, dtype=torch.float32, device,
                      floor_cells: int = 16,
                      grid_resolution=None) -> MeshScene:
    """Config-4 scene: ``n_spheres`` random spheres in a slab above a
    triangle-mesh checker floor, with the demo's lights, its uniform grid
    (``grid_resolution`` cells an axis, by default ``build_grid``'s rule)
    and its cluster pack. The numpy draws from ``default_rng(seed)`` are
    the JAX package's, so both packages build the same scene and grid."""
    touch_device(device)
    with SETUP.setup_span("scene"):
        rng = np.random.default_rng(seed)
        f32 = np.float32
        centers = np.stack([rng.uniform(-15.0, 15.0, n_spheres),
                            rng.uniform(-1.5, 8.0, n_spheres),
                            rng.uniform(-15.0, 15.0, n_spheres)],
                           axis=-1).astype(f32)
        radii = rng.uniform(0.05, 0.25, n_spheres).astype(f32)
        colors = rng.uniform(0.1, 1.0, (n_spheres, 3)).astype(f32)
        refl = rng.uniform(0.0, 0.9, n_spheres).astype(f32)
        spec = np.full(n_spheres, 100.0, f32)
        t = lambda a: torch.as_tensor(  # noqa: E731
            np.ascontiguousarray(a), dtype=dtype, device=device)
        spheres = Spheres(
            center=Vec3(*(t(centers[:, i]) for i in range(3))),
            radius=t(radii),
            material=Materials(Vec3(*(t(colors[:, i]) for i in range(3))),
                               t(refl), t(spec)),
        )
        tris_np = floor_mesh_np(y=-2.0, half_extent=20.0, cells=floor_cells)
        tris = Triangles.from_np(tris_np, dtype=dtype, device=device)
        row = lambda v: Vec3.from_array(t(np.asarray([v])))  # noqa: E731
        return MeshScene(
            spheres=spheres,
            triangles=tris,
            grid=build_grid(spheres, tris, grid_resolution, dtype=dtype,
                            device=device, np_spheres=(centers, radii),
                            np_tris=tris_np),
            clusters=pack_clusters(spheres, tris),
            directional_lights=DirectionalLights(
                direction=row([-1.0, -1.0, -1.0]), color=row([1.0, 1.0, 1.0])),
            point_lights=PointLights(
                position=row([0.0, 4.0, 0.0]), color=row([1.0, 1.0, 1.0]),
                intensity=t(np.asarray([10.0]))),
            camera=Camera.default(width_px, height_px, dtype=dtype,
                                  device=device),
            skybox=skybox,
        )
