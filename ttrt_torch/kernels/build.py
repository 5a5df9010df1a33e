"""Build the CUDA kernels from this package's sources and load them with
ctypes.

Every ``csrc/*.cu`` compiles in its own ``nvcc`` process, all started
together, and one more links the objects into one shared library with a
plain C interface, ``ttrt_torch/_build/libttrt_kernels_<hash>.so``, at
first use. The hash covers every source under ``csrc/`` (headers included)
and the flags, so an edited source builds anew. The flags keep float
arithmetic as the JAX oracle rounds it: ``--fmad=false`` (no contraction
into fused multiply-adds) and no ``--use_fast_math`` (IEEE ``sqrtf`` and
division).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE.parent / "_build"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH, "-std=c++17", "-O3", "--fmad=false", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


def nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else nvcc on PATH, else the
    toolkit's default install location."""
    home = os.environ.get("CUDA_HOME")
    if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def sources() -> list[Path]:
    """The translation units, in a fixed order."""
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    digest = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cu*")):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libttrt_kernels_{digest.hexdigest()[:16]}.so"


def _spawn(args: list) -> tuple:
    """Start one compiler process; returns (args, process)."""
    return args, subprocess.Popen(args, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)


def _run(procs: list) -> str:
    """Wait for every compiler process of ``_spawn``; raise if one failed.
    Returns their reports."""
    report = ""
    failed = []
    for args, proc in procs:
        out, err = proc.communicate()
        report += out + err
        if proc.returncode != 0:
            failed.append(f"{' '.join(args)} ({proc.returncode}):\n{err}")
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    return report


def build() -> tuple[Path, str]:
    """Compile the kernel library if it is not built yet. Returns its path
    and the compiler's report (registers, spills), which is kept beside
    the library (``<library>.ptxas``; empty if that file is gone). Raises
    if nvcc is missing or fails."""
    out = library_path()
    saved = out.with_suffix(".ptxas")
    if out.is_file():
        return out, saved.read_text() if saved.is_file() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, src.stem + ".o") for src in sources()]
        report = _run([_spawn([nvcc(), *NVCC_FLAGS, "-c", "-o", obj,
                               str(src)])
                       for src, obj in zip(sources(), objs)])
        lib = os.path.join(tmp, out.name)
        report += _run([_spawn([nvcc(), *ARCH, "-shared", "-o", lib,
                                *objs])])
        log = os.path.join(tmp, saved.name)
        Path(log).write_text(report)
        os.replace(log, saved)
        os.replace(lib, out)  # atomic: concurrent builders see whole files
    return out, report


@functools.cache
def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with its argtypes."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # scene_buf, n_sph, n_dl, n_pl, W, H, N, n_rows, n_samples,
    # bounce_limit, specular, subtract, sky_kind, sky_dim, bilinear, texels,
    # scale, pixel_rate, out_rgb, out_count, stream
    lib.ttrt_render.restype = ctypes.c_int
    lib.ttrt_render.argtypes = [p] + [i] * 14 + [p, f, i, p, p, p]
    # n_sph, n_dl, n_pl, W, n_rows, n_samples, pixel_rate, out[10]
    lib.ttrt_render_layout.restype = ctypes.c_int
    lib.ttrt_render_layout.argtypes = [i] * 7 + [p]
    # scene_buf, n_sph, n_dl, n_pl, W, H, N, bounce_limit, out_w, stream
    lib.ttrt_sky_weights.restype = ctypes.c_int
    lib.ttrt_sky_weights.argtypes = [p] + [i] * 7 + [p, p]
    # n_sph, n_dl, n_pl, W, H, N, out[10]
    lib.ttrt_sky_weights_layout.restype = ctypes.c_int
    lib.ttrt_sky_weights_layout.argtypes = [i] * 6 + [p]
    # cam, dl, n_dl, pl, n_pl, 9 sphere/triangle tables, qbox, order,
    # kb_sph, kb_tri, W, H, N, n_rows, n_samples, bounce_limit, specular,
    # subtract, sky_kind, sky_dim, bilinear, texels, scale, out_rgb,
    # out_count, stream
    lib.ttrt_mesh_fused.restype = ctypes.c_int
    lib.ttrt_mesh_fused.argtypes = ([p, p, i, p, i] + [p] * 11 + [i] * 13
                                    + [p, f, p, p, p])
    # kb_sph, kb_tri, n_dl, n_pl, W, n_rows, n_samples, out[11]
    lib.ttrt_mesh_fused_layout.restype = ctypes.c_int
    lib.ttrt_mesh_fused_layout.argtypes = [i] * 7 + [p]
    # ox oy oz dx dy dz, n, sph, sph_id, tri, tri_id, qbox, kb_sph, kb_tri,
    # mode, out_t, out_id, stream
    lib.ttrt_cluster_nearest.restype = ctypes.c_int
    lib.ttrt_cluster_nearest.argtypes = ([p] * 6 + [i] + [p] * 5
                                         + [i, i, i, p, p, p])
    # n, out[6]
    lib.ttrt_cluster_nearest_layout.restype = ctypes.c_int
    lib.ttrt_cluster_nearest_layout.argtypes = [i, p]
    # scene_buf, n_sph, n_al, W, H, N, bounce_limit, sky_kind, sky_dim,
    # bilinear, reduce_sum, seed, out_rgb, out_count, stream
    lib.ttrt_pathtrace.restype = ctypes.c_int
    lib.ttrt_pathtrace.argtypes = ([p] + [i] * 10 + [ctypes.c_uint32]
                                   + [p, p, p])
    # n_sph, n_al, W, H, N, reduce_sum, out[10]
    lib.ttrt_pathtrace_layout.restype = ctypes.c_int
    lib.ttrt_pathtrace_layout.argtypes = [i] * 6 + [p]
    # cam, al, n_al, 9 sphere/triangle tables, qbox, order, kb_sph,
    # kb_tri, W, H, N, bounce_limit, sky_kind, sky_dim, bilinear,
    # reduce_sum, seed, out_rgb, out_count, stream
    lib.ttrt_pathtrace_mesh.restype = ctypes.c_int
    lib.ttrt_pathtrace_mesh.argtypes = ([p, p, i] + [p] * 11 + [i] * 10
                                        + [ctypes.c_uint32] + [p, p, p])
    # kb_sph, kb_tri, n_al, W, H, N, out[10]
    lib.ttrt_pathtrace_mesh_layout.restype = ctypes.c_int
    lib.ttrt_pathtrace_mesh_layout.argtypes = [i] * 6 + [p]
    # pos x y z, vel x y z, t, radius, inv_mass, gravity, restitution,
    # ground_y, bounds, dt, n, substeps, out, stream
    lib.ttrt_physics_step.restype = ctypes.c_int
    lib.ttrt_physics_step.argtypes = [p] * 14 + [i, i, p, p]
    # n, out[5]
    lib.ttrt_physics_layout.restype = ctypes.c_int
    lib.ttrt_physics_layout.argtypes = [i, p]
    return lib


def layout(name: str, keys: tuple, *args) -> dict:
    """The launch shape from the library's ``name`` function (a
    ``ttrt_*_layout``, called with ``args`` and an int out[len(keys)]),
    keyed by ``keys``, with ``waves``: the blocks over those the card
    holds at once (``blocks_per_sm`` x ``sms``). Needs a CUDA device;
    raises on a CUDA error."""
    out = (ctypes.c_int * len(keys))()
    rc = getattr(load(), name)(*args, out)
    if rc != 0:
        raise RuntimeError(f"{name} failed: CUDA error {rc}")
    shape = dict(zip(keys, out))
    shape["waves"] = shape["blocks"] / (shape["blocks_per_sm"]
                                        * shape["sms"])
    return shape
