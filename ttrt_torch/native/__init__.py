"""ctypes binding to the native host runtime, ``csrc/ttrt_native.c`` (port
of ``ttrt.native``): the template-patching ANSI encoder, absolute-deadline
pacing, a full write(2) and the monotonic clock.

The library is compiled from that source with the system C compiler at
first import, into ``ttrt_torch/_build/libttrt_native_<hash>.so``; the
hash covers the source and the flags, so an edited source builds anew.
Without a compiler ``available`` is False, and the callers fall back to
the NumPy encoder (``term.encoder.encode_ansi_host``) and ``time.sleep``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "ttrt_native.c"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CFLAGS = ("-O3", "-shared", "-fPIC")

_lib: Optional[ctypes.CDLL] = None
available = False
library_path: Optional[Path] = None


def _target() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CFLAGS).encode())
    return BUILD_DIR / f"libttrt_native_{digest.hexdigest()[:16]}.so"


def _compile() -> Optional[Path]:
    """The built library's path, compiling it if it is not there yet; None
    without the source or a working compiler."""
    if not SOURCE.is_file():
        return None
    out = _target()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for cc in ("cc", "gcc", "clang"):
        # build to a temp file, then rename: test workers import at once
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run([cc, *CFLAGS, "-o", tmp, str(SOURCE)], check=True,
                           capture_output=True)
            os.replace(tmp, out)
            return out
        except (subprocess.CalledProcessError, FileNotFoundError):
            os.unlink(tmp)
    return None


def _load() -> None:
    global _lib, available, library_path
    path = _compile()
    if path is None:
        return
    lib = ctypes.CDLL(str(path))
    p, i, l = ctypes.c_char_p, ctypes.c_int, ctypes.c_long
    lib.ttrt_ansi_size.restype = l
    lib.ttrt_ansi_size.argtypes = [i, i]
    lib.ttrt_init_template.restype = None
    lib.ttrt_init_template.argtypes = [i, i, p]
    lib.ttrt_encode_ansi.restype = None
    lib.ttrt_encode_ansi.argtypes = [p, i, i, p]
    lib.ttrt_write_full.restype = i
    lib.ttrt_write_full.argtypes = [i, p, l]
    lib.ttrt_monotonic.restype = ctypes.c_double
    lib.ttrt_monotonic.argtypes = []
    lib.ttrt_sleep_until.restype = None
    lib.ttrt_sleep_until.argtypes = [ctypes.c_double]
    _lib, available, library_path = lib, True, path


try:
    _load()
except OSError:  # no build directory, or a library that does not load
    _lib, available, library_path = None, False, None


class NativeAnsiEncoder:
    """The reference's buffered_draw_screen (TerminalRayTracer.c:1101-1172)
    in C for compact (H, W, 3) uint8 frames: the escape template is built
    once a resolution, and each frame patches only its digit bytes."""

    def __init__(self, height: int, width: int):
        if not available:
            raise RuntimeError("the native runtime is not available")
        self.height = height
        self.width = width
        self.size = int(_lib.ttrt_ansi_size(height, width))
        self._buf = np.empty(self.size, np.uint8)
        _lib.ttrt_init_template(height, width,
                                self._buf.ctypes.data_as(ctypes.c_char_p))

    def encode(self, rgb: np.ndarray) -> np.ndarray:
        """(H, W, 3) uint8 -> the ANSI bytes, in a buffer this encoder owns
        and rewrites on its next call."""
        rgb = np.ascontiguousarray(rgb, np.uint8)
        if rgb.shape != (self.height, self.width, 3):
            raise ValueError(f"frame of shape {rgb.shape}, encoder for "
                             f"{(self.height, self.width, 3)}")
        _lib.ttrt_encode_ansi(rgb.ctypes.data_as(ctypes.c_char_p),
                              self.height, self.width,
                              self._buf.ctypes.data_as(ctypes.c_char_p))
        return self._buf

    def write(self, fd: int) -> None:
        """Write the last encoded frame to ``fd`` in full."""
        if _lib.ttrt_write_full(
                fd, self._buf.ctypes.data_as(ctypes.c_char_p), self.size):
            raise OSError("ttrt_write_full failed")


def monotonic() -> float:
    """CLOCK_MONOTONIC in seconds (``time.monotonic``'s clock on Linux)."""
    return float(_lib.ttrt_monotonic()) if available else time.monotonic()


def sleep_until(deadline: float) -> None:
    """Sleep until an absolute ``monotonic()`` deadline: drift-free pacing;
    a deadline in the past returns at once."""
    if available:
        _lib.ttrt_sleep_until(deadline)
        return
    delay = deadline - time.monotonic()
    if delay > 0:
        time.sleep(delay)


def write_full(fd: int, buf) -> None:
    """Write all of ``buf`` to ``fd``, across partial writes and EINTR."""
    b = np.frombuffer(bytes(buf), np.uint8)
    if not available:
        view = memoryview(b.tobytes())
        while view:
            view = view[os.write(fd, view):]
        return
    if _lib.ttrt_write_full(fd, b.ctypes.data_as(ctypes.c_char_p), b.size):
        raise OSError("ttrt_write_full failed")
