"""The cluster-culled nearest-hit kernel's wrapper and its plain version
(port of ``ttrt/kernels/mesh_pallas.py::cluster_nearest``).

``cluster_nearest`` dispatches on the device of the rays: CPU tensors go
through ``cluster_nearest_plain``, CUDA tensors through
``cluster_nearest_cuda``, which launches the kernel in ``csrc/mesh.cu`` or
raises. Both read the pack's kernel tables (``mesh.clusters.KernelTables``,
laid out once when the pack is built), the whole pack's or an objects
shard's (``parallel/objects.py``), and return the nearest (t, original id),
t = inf and id = -1 on a miss, with exact float ties resolved to the
lowest id. The kernel's two modes ("cull", "dense") and the plain version
agree bit for bit whatever order they visit the objects in.
"""

from __future__ import annotations

from typing import Union

import torch

from ttrt_torch.config import ConfigError
from ttrt_torch.mesh.clusters import ClusterPack, KernelTables
from ttrt_torch.mesh.dense import NearestHit, nearest_arrays
from ttrt_torch.vec import Vec3

MODES = {"cull": 0, "dense": 1}


def _tables(pack: Union[ClusterPack, KernelTables]) -> KernelTables:
    """A pack's kernel tables; an objects shard is its tables alone."""
    return pack.tables if isinstance(pack, ClusterPack) else pack


def _float32_rays(o: Vec3, d: Vec3) -> list:
    """The six flat, contiguous ray components; the kernel is float32, and
    other ray dtypes are refused, not cast."""
    rays = [c.reshape(-1).contiguous() for c in (*o, *d)]
    if any(r.dtype != torch.float32 for r in rays):
        raise ConfigError("the cluster_nearest kernel traces float32 rays "
                          f"only, got {rays[0].dtype}")
    n = rays[0].numel()
    if any(r.numel() != n for r in rays):
        raise ValueError("ray components differ in length")
    return rays


def cluster_nearest_plain(pack: Union[ClusterPack, KernelTables], o: Vec3,
                          d: Vec3) -> NearestHit:
    """The kernel's ``mode="dense"`` in plain PyTorch: every real object of
    the tables (id >= 0) tested with the kernel's arithmetic
    (``mesh.dense.nearest_arrays`` on the tables' own ccr2 and triangle
    edges), spheres by ascending id, then triangles, so the first minimum
    is the lowest id."""
    tab = _tables(pack)
    rays = _float32_rays(o, d)
    cluster_nearest_plain.launches += 1
    s_ids, s_ord = torch.sort(tab.sph_id[tab.sph_id >= 0])
    t_ids, t_ord = torch.sort(tab.tri_id[tab.tri_id >= 0])
    sph = tab.sph[tab.sph_id >= 0][s_ord]
    tri = tab.tri[tab.tri_id >= 0][t_ord][:, :9]
    gh = nearest_arrays(sph, tri, sph.shape[0], Vec3(*rays[:3]),
                        Vec3(*rays[3:]))
    ids = torch.cat([s_ids, t_ids])
    hit = gh.obj >= 0
    obj = torch.where(hit, ids[torch.clamp(gh.obj, 0).long()], -1) \
        if ids.numel() else gh.obj
    return NearestHit(gh.t, obj.to(torch.int32))


cluster_nearest_plain.launches = 0


def cluster_nearest_cuda(pack: Union[ClusterPack, KernelTables], o: Vec3,
                         d: Vec3, *, mode: str = "cull") -> NearestHit:
    """Launch the CUDA kernel (csrc/mesh.cu, ``ttrt_cluster_nearest``): one
    thread per ray, a subcluster's four quarter AABBs slab-tested ahead of
    their 32 objects each (``mode="cull"``) or every object tested
    (``"dense"``); ``nearest_layout`` gives the launch shape. The kernel
    is float32: other ray dtypes are refused, not cast."""
    from ttrt_torch.kernels import build

    if mode not in MODES:
        raise ValueError(f"mode must be one of {sorted(MODES)}, got {mode!r}")
    tab = _tables(pack)
    rays = _float32_rays(o, d)
    dev = rays[0].device
    if dev.type != "cuda" or tab.sph.device != dev:
        raise ValueError("cluster_nearest_cuda needs the rays and the pack "
                         f"on one CUDA device, got {dev} and "
                         f"{tab.sph.device}")
    n = rays[0].numel()
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


def cluster_nearest(pack: Union[ClusterPack, KernelTables], o: Vec3,
                    d: Vec3) -> NearestHit:
    """Nearest (t, id) on the device of the rays: the plain version for
    CPU tensors, the culled CUDA kernel for CUDA tensors."""
    if o.x.device.type == "cpu":
        return cluster_nearest_plain(pack, o, d)
    return cluster_nearest_cuda(pack, o, d)


NEAREST_LAYOUT_KEYS = ("threads_per_block", "blocks", "blocks_per_sm", "sms",
                       "registers", "local_bytes")


def nearest_layout(n: int) -> dict:
    """The launch shape ``cluster_nearest_cuda`` takes for ``n`` rays
    (``ttrt_cluster_nearest_layout``): threads of a block, the blocks, the
    blocks an SM holds and the SMs (hence ``waves``), and the kernel's
    registers and local (spill) bytes a thread. Needs a CUDA device."""
    from ttrt_torch.kernels import build

    return build.layout("ttrt_cluster_nearest_layout", NEAREST_LAYOUT_KEYS,
                        n)
