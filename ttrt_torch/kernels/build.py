"""Build the CUDA kernels from this package's sources and load them with
ctypes.

``nvcc`` compiles ``csrc/render.cu`` into a shared library with a plain C
interface, ``ttrt_torch/_build/librender_<hash>.so``, at first use. The hash
covers the source and the flags, so an edited source builds anew. The
flags keep float arithmetic as the JAX oracle rounds it: ``--fmad=false``
(no contraction into fused multiply-adds) and no ``--use_fast_math`` (IEEE
``sqrtf`` and division).
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
SOURCE = _HERE / "csrc" / "render.cu"
BUILD_DIR = _HERE.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else nvcc on PATH, else the
    toolkit's default install location."""
    home = os.environ.get("CUDA_HOME")
    if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"librender_{digest.hexdigest()[:16]}.so"


def build() -> tuple[Path, str]:
    """Compile the kernel library if it is not built yet. Returns its path
    and the compiler's report (registers, spills; empty when the library
    was already built). Raises if nvcc is missing or fails."""
    out = library_path()
    if out.is_file():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: concurrent builders see whole files
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out, proc.stdout + proc.stderr


@functools.cache
def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with its argtypes."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ttrt_render_limits.restype = None
    lib.ttrt_render_limits.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.ttrt_render.restype = ctypes.c_int
    lib.ttrt_render.argtypes = [p, i, i, i, i, i, i, i, i, i, i, i, p, p, p]
    return lib
