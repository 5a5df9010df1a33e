"""The cluster-culled nearest-hit kernel's wrapper (port of
``ttrt/kernels/mesh_pallas.py::cluster_nearest``).

``cluster_nearest_cuda`` launches the kernel in ``csrc/mesh.cu`` on CUDA
tensors and raises on anything else. It returns the nearest (t, original
id), t = inf and id = -1 on a miss, and resolves exact float ties to the
lowest id. Its plain version is the dense tester
``ttrt_torch.mesh.dense.dense_nearest``, which ``mesh.scene.trace_ray_mesh``
takes for CPU tensors; the two agree bit for bit whatever order the kernel
visits the objects in. The kernel reads the pack's ``tables``
(``mesh.clusters.KernelTables``), laid out once when the pack is built.
"""

from __future__ import annotations

import torch

from ttrt_torch.config import ConfigError
from ttrt_torch.mesh.clusters import ClusterPack
from ttrt_torch.mesh.dense import NearestHit
from ttrt_torch.vec import Vec3

MODES = {"cull": 0, "dense": 1}


def cluster_nearest_cuda(pack: ClusterPack, o: Vec3, d: Vec3, *,
                         mode: str = "cull") -> NearestHit:
    """Launch the CUDA kernel (csrc/mesh.cu, ``ttrt_cluster_nearest``): one
    thread per ray, the quarter AABBs slab-tested ahead of their 32
    objects (``mode="cull"``) or every object tested (``"dense"``). The
    kernel is float32: other ray dtypes are refused, not cast."""
    from ttrt_torch.kernels import build

    if mode not in MODES:
        raise ValueError(f"mode must be one of {sorted(MODES)}, got {mode!r}")
    rays = [c.reshape(-1).contiguous() for c in (*o, *d)]
    if any(r.dtype != torch.float32 for r in rays):
        raise ConfigError("the cluster_nearest kernel traces float32 rays "
                          f"only, got {rays[0].dtype}")
    dev = rays[0].device
    if dev.type != "cuda" or pack.sph.device != dev:
        raise ValueError("cluster_nearest_cuda needs the rays and the pack "
                         f"on one CUDA device, got {dev} and "
                         f"{pack.sph.device}")
    n = rays[0].numel()
    if any(r.numel() != n for r in rays):
        raise ValueError("ray components differ in length")
    tab = pack.tables
    out_t = torch.empty(n, dtype=torch.float32, device=dev)
    out_id = torch.empty(n, dtype=torch.int32, device=dev)
    lib = build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.ttrt_cluster_nearest(
        *(r.data_ptr() for r in rays), n,
        tab.sph.data_ptr(), tab.sph_id.data_ptr(), tab.tri.data_ptr(),
        tab.tri_id.data_ptr(), tab.qbox.data_ptr(), tab.kb_sph, tab.kb_tri,
        MODES[mode], out_t.data_ptr(), out_id.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(
            f"cluster_nearest kernel launch failed: CUDA error {rc}")
    cluster_nearest_cuda.launches += 1
    return NearestHit(out_t, out_id)


cluster_nearest_cuda.launches = 0
