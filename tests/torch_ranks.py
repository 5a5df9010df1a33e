"""Spawned gloo worlds for the port's multi-rank tests on the CPU.

``run_world`` starts one process a rank (``multiprocessing``, spawn), each
joining a gloo process group on a ``FileStore`` under the test's
``tmp_path`` (no TCP port, so parallel test workers cannot collide), and
calls one of this module's rank functions in it. The ranks are fresh
interpreters that import this module and the port, never JAX. Every
rank's result comes back through a file; a rank that fails or outlives
the timeout fails the test, and no process is left behind.

The rank functions build their inputs from numpy arrays the test wrote
(``inputs.npz``: scene leaves keyed ``<name>.<field path>``), or from the
port's own seeded scenes.
"""

from __future__ import annotations

import multiprocessing
import os
import time
import traceback
from datetime import timedelta
from pathlib import Path

import numpy as np

JOIN_TIMEOUT = 180.0  # seconds for a whole world, start-up included
PG_TIMEOUT = timedelta(seconds=60)


def run_world(fn, world_size: int, tmp_path: Path, *args,
              timeout: float = JOIN_TIMEOUT) -> list:
    """Run ``fn(*args)`` on ``world_size`` spawned gloo ranks; returns each
    rank's result, in rank order. Raises AssertionError, after ending
    every rank, when one fails or the world outlives ``timeout``."""
    tmp_path = Path(tmp_path)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world_size, str(tmp_path), args))
             for r in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.0))
    finally:
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.terminate()
        for p in alive:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
    if alive:
        raise AssertionError(f"{len(alive)} of {world_size} ranks still "
                             f"ran after {timeout} s")
    errors = [(tmp_path / f"rank{r}.err") for r in range(world_size)]
    failed = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode]
    if failed:
        raise AssertionError(
            f"ranks failed {failed}: " + "\n".join(
                e.read_text() for e in errors if e.is_file()))
    import torch

    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
            for r in range(world_size)]


def _rank_main(fn, rank: int, world_size: int, out_dir: str, args) -> None:
    os.environ["OMP_NUM_THREADS"] = "1"
    import torch
    import torch.distributed as dist

    from ttrt_torch.parallel.mesh import open_world

    torch.set_num_threads(1)
    out = Path(out_dir)
    try:
        store = dist.FileStore(str(out / "store"), world_size)
        with open_world("cpu", store=store, rank=rank, world_size=world_size,
                        timeout=PG_TIMEOUT):
            result = fn(out, *args)
        torch.save(result, out / f"rank{rank}.pt")
    except BaseException:
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        raise


def _scene(leaves, name: str, procedural, dtype):
    from ttrt_torch.scene import scene_from_numpy

    prefix = name + "."
    return scene_from_numpy(
        {k[len(prefix):]: leaves[k] for k in leaves.files
         if k.startswith(prefix)}, procedural, device="cpu", dtype=dtype)


def _frame(fb) -> np.ndarray:
    return fb.to_array().numpy()


def sharding_world(out: Path, many_spheres: int, seed: int) -> dict:
    """The ray-axis renderers on this rank of a 2x2 mesh, every frame
    returned whole (as every rank holds it): the eager integrator in
    float64 on the scene ``f64``, the demo kernel's plain partials on
    ``f32``, the fused kernel's plain partials on a ``many_spheres``
    MeshScene, the path-tracing kernel's and the eager estimator's with
    frame seed ``seed``, the ANSI frame of ``make_sharded_frame_fn``,
    and the refusal of an indivisible height."""
    import torch
    import torch.distributed as dist

    from ttrt_torch import assets, routes
    from ttrt_torch.config import ConfigError, RenderConfig
    from ttrt_torch.mesh.scene import many_sphere_scene
    from ttrt_torch.parallel import sharding
    from ttrt_torch.parallel.mesh import mesh_from_spec
    from ttrt_torch.render import pathtrace as estimator

    leaves = np.load(out / "inputs.npz")
    W, H, N, B = (int(v) for v in leaves["config"])
    mesh = mesh_from_spec("2x2", "cpu")
    res = {"rank": dist.get_rank(), "coordinate": mesh.get_coordinate()}
    f64 = RenderConfig(width=W, height=H, rays_per_pixel=N, bounce_limit=B,
                       dtype=torch.float64)
    fb, rays = sharding.render_frame_sharded(
        _scene(leaves, "f64", "colors", torch.float64), f64, mesh)
    res["eager"], res["eager_rays"] = _frame(fb), int(rays)
    f32 = f64.with_(dtype=torch.float32)
    demo = _scene(leaves, "f32", "colors", torch.float32)
    fb, rays = sharding.render_frame_sharded_kernel(demo, f32, mesh)
    res["kernel"], res["kernel_rays"] = _frame(fb), int(rays)
    many = many_sphere_scene(assets.load_skybox("colors", device="cpu"),
                             many_spheres, W, H, device="cpu")
    many = many.with_camera_frame(demo.camera.frame)
    fb, rays = sharding.render_frame_sharded_mesh_fused(many, f32, mesh)
    res["fused"], res["fused_rays"] = _frame(fb), int(rays)
    lights = estimator.default_area_lights(f32, "cpu")
    res["pathtrace"] = _frame(sharding.pathtrace_frame_sharded_kernel(
        demo, lights, f32, seed, mesh))
    res["estimator"] = _frame(sharding.pathtrace_frame_sharded(
        demo, lights, f32, seed, mesh))
    buf, rays = sharding.make_sharded_frame_fn(demo, f32, mesh)(0.5)
    res["ansi"], res["ansi_rays"] = buf.numpy().tobytes(), int(rays)
    res["refusals"] = []
    for cfg in (f32.with_(height=H + 1), f32.with_(rays_per_pixel=N + 1)):
        try:
            routes.pick(demo, cfg, mesh=mesh)
        except ConfigError as e:
            res["refusals"].append(str(e))
    return res


def objects_world(out: Path, many_spheres: int) -> dict:
    """The objects axis on this rank of a 1x1x2 mesh: the frame of
    ``render_frame_sharded_objects`` (float32), ``combine_nearest`` of the
    hand-made (t, id) pairs in ``inputs.npz`` (``t{rank}``, ``id{rank}``),
    and the combine of an exact tie in t across the shards: each rank's
    shard holds the same sphere under its own id (``tie_ids``)."""
    import torch
    import torch.distributed as dist

    from ttrt_torch import assets
    from ttrt_torch.config import RenderConfig
    from ttrt_torch.kernels.mesh import cluster_nearest
    from ttrt_torch.mesh.clusters import pack_clusters
    from ttrt_torch.mesh.dense import NearestHit
    from ttrt_torch.mesh.scene import many_sphere_scene
    from ttrt_torch.parallel import objects
    from ttrt_torch.parallel.mesh import mesh_from_spec
    from ttrt_torch.scene import Spheres
    from ttrt_torch.vec import Vec3

    inputs = np.load(out / "inputs.npz")
    W, H, N, B = (int(v) for v in inputs["config"])
    rank = dist.get_rank()
    mesh = mesh_from_spec("1x1x2", "cpu")
    cfg = RenderConfig(width=W, height=H, rays_per_pixel=N, bounce_limit=B)
    scene = many_sphere_scene(assets.load_skybox("colors", device="cpu"),
                              many_spheres, W, H, device="cpu")
    fb, rays = objects.render_frame_sharded_objects(scene, cfg, mesh)
    res = {"frame": _frame(fb), "rays": int(rays)}
    group = mesh.get_group("objects")
    hand = NearestHit(torch.from_numpy(inputs[f"t{rank}"]),
                      torch.from_numpy(inputs[f"id{rank}"]))
    gh = objects.combine_nearest(hand, group)
    res["hand"] = (gh.t.numpy(), gh.obj.numpy())
    # an exact tie: one sphere, held by both shards under different ids
    tables = pack_clusters(
        Spheres.create(inputs["tie_center"][None], [0.5], [[1.0, 0.0, 0.0]],
                       0.0, dtype=torch.float32, device="cpu"), None).tables
    shard = tables._replace(sph_id=torch.where(
        tables.sph_id >= 0, int(inputs["tie_ids"][rank]), -1).to(torch.int32))
    o = Vec3(*(torch.from_numpy(c) for c in inputs["tie_o"]))
    d = Vec3(*(torch.from_numpy(c) for c in inputs["tie_d"]))
    local = cluster_nearest(shard, o, d)
    gh = objects.combine_nearest(local, group)
    res["tie_local"] = (local.t.numpy(), local.obj.numpy())
    res["tie"] = (gh.t.numpy(), gh.obj.numpy())
    return res
