"""The process group and the device mesh of ``--mesh`` (port of the
``jax.sharding.Mesh`` that ``ttrt/parallel/sharding.py::make_mesh`` and
``mesh_from_spec`` build, :38-97).

One process drives one device: a rank. Under ``torchrun`` each rank reads
RANK, WORLD_SIZE and LOCAL_RANK from its environment and renders on
``cuda:LOCAL_RANK``. Without a launcher, ``open_world`` builds a one-rank
world itself on an in-memory ``HashStore``, so ``--mesh auto`` or ``1x1``
runs on one card. The backend follows the device, by rule and not as a
fallback: NCCL for CUDA, gloo for the CPU (NCCL takes one rank a GPU; the
CPU tests run several gloo ranks on one host).

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` named
("rows", "samples") or ("rows", "samples", "objects"), ranks laid out in
row-major order: the rank at coordinate (i, j[, k]) is the JAX mesh's
device at the same place, and its flattened index (i*S + j)[*O + k] is
the one JAX's ``lax.axis_index`` walk gives.
"""

from __future__ import annotations

import contextlib
import itertools
import math
import os
import re
from datetime import timedelta
from typing import Dict, Iterator, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ttrt_torch.config import ConfigError

RAY_AXES = ("rows", "samples")
OBJECTS = "objects"
# how long a collective may wait for the slowest rank's frame
TIMEOUT = timedelta(seconds=300)


def local_device(device) -> torch.device:
    """The device this rank renders on: ``cuda:LOCAL_RANK`` (LOCAL_RANK 0
    without a launcher) for ``"cuda"``, else ``device`` itself."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return device


def backend(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


@contextlib.contextmanager
def open_world(device, *, store: Optional[dist.Store] = None, rank: int = 0,
               world_size: int = 1,
               timeout: timedelta = TIMEOUT) -> Iterator[None]:
    """Make the default process group unless one exists, and destroy it on
    exit if it made it. Under a launcher (RANK and WORLD_SIZE in the
    environment) the group rendezvouses by the environment; otherwise on
    ``store`` (a one-rank ``HashStore`` by default) as ``rank`` of
    ``world_size``."""
    if dist.is_initialized():
        yield
        return
    device = local_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kw = dict(backend=backend(device), timeout=timeout)
    if store is None and "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(init_method="env://", **kw)
    else:
        dist.init_process_group(
            store=dist.HashStore() if store is None else store, rank=rank,
            world_size=world_size, **kw)
    try:
        yield
    finally:
        dist.destroy_process_group()


def parse_spec(spec: str, n_devices: int) -> tuple:
    """``--mesh`` spec -> the mesh's shape: ``"auto"`` puts every device
    on the rows axis, ``"RxS"`` (e.g. ``4x2``) builds the (rows, samples)
    ray mesh, ``"RxSxO"`` (e.g. ``2x2x2``) adds the objects axis. The
    shape must tile the ``n_devices`` ranks exactly. JAX's messages, as
    ConfigError."""
    if spec == "auto":
        return (n_devices, 1)
    if not re.fullmatch(r"0*[1-9]\d*(x0*[1-9]\d*){1,2}", spec.lower()):
        raise ConfigError(
            f"--mesh expects 'auto', ROWSxSAMPLES (e.g. 4x2) or "
            f"ROWSxSAMPLESxOBJECTS (e.g. 2x2x2), got {spec!r}")
    factors = tuple(int(q) for q in spec.lower().split("x"))
    n_total = math.prod(factors)
    if n_total != n_devices:
        raise ConfigError(
            f"--mesh {spec} needs {n_total} devices but {n_devices} are "
            f"available")
    return factors


def mesh_from_spec(spec: str, device) -> DeviceMesh:
    """The named device mesh of a ``--mesh`` spec over the ranks of the
    default process group (``open_world``), one device a rank."""
    shape = parse_spec(spec, dist.get_world_size())
    names = RAY_AXES + ((OBJECTS,) if len(shape) == 3 else ())
    return init_device_mesh(local_device(device).type, shape,
                            mesh_dim_names=names)


@contextlib.contextmanager
def open_mesh(spec: str, device) -> Iterator[DeviceMesh]:
    """``open_world`` and the mesh of ``spec`` over it."""
    with open_world(device):
        yield mesh_from_spec(spec, device)


def shape(mesh: DeviceMesh) -> Dict[str, int]:
    """Axis name -> size."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def coordinate(mesh: DeviceMesh) -> Dict[str, int]:
    """Axis name -> this rank's index along it."""
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def flat_index(mesh: DeviceMesh) -> int:
    """This rank's row-major index over every axis of the mesh (JAX's
    ``axis_index`` walk, sharding.py:252-254)."""
    idx = 0
    for name, i in coordinate(mesh).items():
        idx = idx * shape(mesh)[name] + i
    return idx


def gather(mesh: DeviceMesh, part: torch.Tensor) -> Dict[tuple, torch.Tensor]:
    """Every rank's ``part`` (one shape on all ranks), keyed by the rank's
    mesh coordinate: one all_gather over the world. The collective only
    moves the parts; the caller combines them in a fixed order, so the
    result does not depend on the transport's reduction order."""
    part = part.contiguous()
    parts = [torch.empty_like(part) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, part)
    layout = mesh.mesh
    return {idx: parts[int(layout[idx])]
            for idx in itertools.product(*(range(n) for n in layout.shape))}
