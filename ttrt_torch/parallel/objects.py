"""The objects axis: the geometry sharded over the mesh (port of
``ttrt/parallel/objects.py``).

The ray axes (``parallel.sharding``) replicate the geometry on every rank.
The objects axis shards the Morton-ordered subclusters of the cluster pack
instead: each rank of an objects group holds 1/O of them, traces every
ray of its band x slice against its slice with ``cluster_nearest`` (the
kernel on the card, its plain version on the CPU), and a cross-rank
argmin by t picks the winner of each trace:

    t_min = all_reduce(MIN, t_local)
    obj   = all_reduce(MIN, obj_local where t == t_min)   # ties: lowest id

The pack carries the ORIGINAL object ids, so the lowest id wins an exact
tie in t whichever shard holds it: the sequential reference scan's rule
(TerminalRayTracer.c:824-856) and the single-device kernels'. Everything
above the trace (the bounce loop, the lighting and its shadow rays, the
sky: the eager integrator) runs identically on every rank of the group
after each combine, on the replicated raw geometry, so the ranks of a
group make the same collectives in the same order.

A shard's tables are rows of the whole pack's kernel tables
(``mesh.clusters.KernelTables``), never a pack built anew: the quarter
boxes keep the whole pack's BOX_PAD widening, so a shard culls exactly as
the whole pack does.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ttrt_torch.config import RenderConfig
from ttrt_torch.kernels.mesh import cluster_nearest
from ttrt_torch.mesh.clusters import BLOCK, QUARTERS, KernelTables
from ttrt_torch.mesh.dense import NearestHit
from ttrt_torch.mesh.scene import MeshScene, _finish_hit
from ttrt_torch.parallel.mesh import OBJECTS, coordinate
from ttrt_torch.parallel.mesh import shape as mesh_shape
from ttrt_torch.parallel.sharding import (band_of, band_rays, gather_bands,
                                          sample_sums)
from ttrt_torch.render import dispatch, integrator
from ttrt_torch.vec import Vec3

INT_MAX = 2**31 - 1
_PAD_CCR2 = 1.0e30  # mesh.clusters' padding sphere: no ray can hit it


class ObjectShardedMeshScene(NamedTuple):
    """``MeshScene`` whose registered trace combines each rank's nearest
    hit over its objects group. ``clusters`` holds this rank's shard of
    the kernel tables; every other field is the replicated scene's, so
    the integrator, the lighting and ``_finish_hit`` are oblivious."""

    spheres: object
    triangles: object
    grid: None
    directional_lights: object
    point_lights: object
    camera: object
    skybox: object
    clusters: KernelTables
    group: Optional[dist.ProcessGroup] = None

    def with_camera_frame(self, frame) -> "ObjectShardedMeshScene":
        return self._replace(camera=self.camera._replace(frame=frame))


def _pad_rows(t: torch.Tensor, at: int, n: int, fill: float) -> torch.Tensor:
    """``t`` with ``n`` rows of ``fill`` inserted before row ``at``."""
    if n == 0:
        return t
    pad = torch.full((n,) + tuple(t.shape[1:]), fill, dtype=t.dtype,
                     device=t.device)
    return torch.cat([t[:at], pad, t[at:]])


def pad_pack_subclusters(tables: KernelTables, n: int) -> KernelTables:
    """Pad both subcluster axes (spheres', triangles') to multiples of
    ``n`` so an n-way objects shard divides evenly (``objects.py:73``).
    Padding subclusters are inert: their quarters hold 0 objects, which
    every walk skips, and their rows carry id -1 (a sphere's ccr2 1e30, so
    no ray could hit it anyway)."""
    kb_s, kb_t = tables.kb_sph, tables.kb_tri
    pad_s = (-kb_s) % n if kb_s else 0
    pad_t = (-kb_t) % n if kb_t else 0
    if not pad_s and not pad_t:
        return tables
    ns, nt = kb_s * BLOCK, kb_t * BLOCK
    ps, pt = pad_s * BLOCK, pad_t * BLOCK
    sph = _pad_rows(tables.sph, ns, ps, 0.0)
    sph[ns:ns + ps, 3] = _PAD_CCR2
    return tables._replace(
        sph=sph,
        sph_mat=_pad_rows(tables.sph_mat, ns, ps, 0.0),
        sph_spec=_pad_rows(tables.sph_spec, ns, ps, 0.0),
        sph_id=_pad_rows(tables.sph_id, ns, ps, -1),
        tri=_pad_rows(tables.tri, nt, pt, 0.0),
        tri_nrm=_pad_rows(tables.tri_nrm, nt, pt, 0.0),
        tri_mat=_pad_rows(tables.tri_mat, nt, pt, 0.0),
        tri_spec=_pad_rows(tables.tri_spec, nt, pt, 0.0),
        tri_id=_pad_rows(tables.tri_id, nt, pt, -1),
        # the quarter boxes: spheres' subclusters, then the triangles'
        qbox=_pad_rows(_pad_rows(tables.qbox, kb_s * QUARTERS,
                                 pad_s * QUARTERS, 0.0),
                       (kb_s + pad_s + kb_t) * QUARTERS, pad_t * QUARTERS,
                       0.0),
        kb_sph=kb_s + pad_s, kb_tri=kb_t + pad_t,
        # the tree's leaves number the triangles from the unpadded kb_sph
        nodes=None,
    )


def shard_tables(tables: KernelTables, n: int, k: int) -> KernelTables:
    """Shard ``k`` of ``n`` of tables padded by ``pad_pack_subclusters``:
    the k-th n-th of the sphere subclusters and of the triangle
    subclusters, rows k*s*128... of the object tables and k*s*4... of the
    quarter boxes (the sphere subclusters' before the triangles')."""
    s, t = tables.kb_sph // n, tables.kb_tri // n
    if s * n != tables.kb_sph or t * n != tables.kb_tri:
        raise ValueError(f"{tables.kb_sph} + {tables.kb_tri} subclusters "
                         f"do not split {n} ways: pad them first")
    so, to = slice(k * s * BLOCK, (k + 1) * s * BLOCK), \
        slice(k * t * BLOCK, (k + 1) * t * BLOCK)
    q0 = tables.kb_sph * QUARTERS
    qbox = torch.cat([
        tables.qbox[k * s * QUARTERS:(k + 1) * s * QUARTERS],
        tables.qbox[q0 + k * t * QUARTERS:q0 + (k + 1) * t * QUARTERS]])
    return KernelTables(
        sph=tables.sph[so].contiguous(),
        sph_mat=tables.sph_mat[so].contiguous(),
        sph_spec=tables.sph_spec[so].contiguous(),
        sph_id=tables.sph_id[so].contiguous(),
        tri=tables.tri[to].contiguous(),
        tri_nrm=tables.tri_nrm[to].contiguous(),
        tri_mat=tables.tri_mat[to].contiguous(),
        tri_spec=tables.tri_spec[to].contiguous(),
        tri_id=tables.tri_id[to].contiguous(),
        qbox=qbox.contiguous(), kb_sph=s, kb_tri=t)


def merge_nearest(hits: Sequence[NearestHit]) -> NearestHit:
    """The global nearest (t, id) of the shards' nearest hits: the least
    t, then the least id among the shards at that t (-1 when every shard
    missed). ``combine_nearest``'s arithmetic on hits held together."""
    t = torch.stack([h.t for h in hits])
    obj = torch.stack([h.obj for h in hits])
    tmin = t.min(dim=0).values
    cand = torch.where((t == tmin) & (obj >= 0), obj, INT_MAX)
    best = cand.min(dim=0).values
    return NearestHit(tmin, _miss_fix(tmin, best))


def _miss_fix(tmin: torch.Tensor, obj: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isinf(tmin) | (obj == INT_MAX), -1,
                       obj).to(torch.int32)


def combine_nearest(gh: NearestHit, group) -> NearestHit:
    """Cross-rank argmin by t over ``group`` (objects.py:140-149): one
    all_reduce(MIN) of t, one of the candidate id where t == t_min. Exact
    ties resolve to the LOWEST object id. MIN is exact and commutative,
    so this equals ``merge_nearest`` of the same hits."""
    tmin = gh.t.clone()
    dist.all_reduce(tmin, op=dist.ReduceOp.MIN, group=group)
    cand = torch.where((gh.t == tmin) & (gh.obj >= 0), gh.obj,
                       INT_MAX).to(torch.int32)
    dist.all_reduce(cand, op=dist.ReduceOp.MIN, group=group)
    return NearestHit(tmin, _miss_fix(tmin, cand))


def trace_ray_mesh_objects(scene: ObjectShardedMeshScene, o: Vec3, d: Vec3,
                           *, sample_sky: bool = True,
                           bilinear: bool = False):
    """Registered trace: the nearest hit on this rank's shard, combined
    over the objects group, then ``_finish_hit`` (attributes gathered from
    the replicated raw geometry, the reference's miss fixups)."""
    gh = cluster_nearest(scene.clusters, o, d)
    return _finish_hit(scene, o, d, combine_nearest(gh, scene.group),
                       sample_sky, bilinear)


dispatch.register_trace(ObjectShardedMeshScene, trace_ray_mesh_objects)


def shard_scene_objects(scene: MeshScene,
                        mesh: DeviceMesh) -> ObjectShardedMeshScene:
    """``MeshScene`` -> this rank's ``ObjectShardedMeshScene``: the kernel
    tables padded for an even split over the objects axis and cut to this
    rank's shard, and the objects group to combine over."""
    if scene.clusters is None:
        raise ValueError("object sharding needs a cluster pack")
    n, k = mesh_shape(mesh)[OBJECTS], coordinate(mesh)[OBJECTS]
    tables = shard_tables(pad_pack_subclusters(scene.clusters.tables, n), n,
                          k)
    return ObjectShardedMeshScene(
        spheres=scene.spheres, triangles=scene.triangles, grid=None,
        directional_lights=scene.directional_lights,
        point_lights=scene.point_lights, camera=scene.camera,
        skybox=scene.skybox, clusters=tables,
        group=mesh.get_group(OBJECTS))


def render_frame_sharded_objects(scene: MeshScene, cfg: RenderConfig,
                                 mesh: DeviceMesh, *,
                                 count_rays: bool = True):
    """The whole frame with the geometry sharded over the objects axis,
    composed with the ray axes (objects.py:197): each rank traces its band
    x slice with the eager integrator against its subcluster slice, the
    nearest hits combine per trace over the objects group, and the band
    sums combine as ``parallel.sharding``'s. ``cluster_nearest`` is
    float32 (and refuses other rays), so the config must be too."""
    if OBJECTS not in mesh.mesh_dim_names:
        raise ValueError(f"mesh has no '{OBJECTS}' axis: "
                         f"{mesh.mesh_dim_names}")
    band = band_of(cfg, mesh)
    sharded = shard_scene_objects(scene, mesh)
    o, d = band_rays(scene, cfg, band)
    color, rays = integrator.trace_batch(sharded, o, d, cfg, count_rays=True)
    fb = sample_sums(color, band.n_rows, cfg.width, band.n_samples)
    return gather_bands(mesh, cfg, fb,
                                  rays if count_rays else None)
