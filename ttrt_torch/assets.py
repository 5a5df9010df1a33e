"""Host-side asset I/O: PPM textures and cubemap skyboxes (port of
``ttrt.assets``).

Reproduces the reference's asset layer (``read_ppm``
TerminalRayTracer.c:307-380, ``load_skybox`` TerminalRayTracer.c:382-427):
binary P6 only, ``#`` header comments, maxval 255, six square faces of one
size. Errors raise ``AssetError`` instead of the reference's ``exit(1)``.

The procedural cubemap generators are numpy and copied verbatim from the
JAX package: the render kernel's in-kernel sky is bit-identical to their
float32 texels.
"""

from __future__ import annotations

import io
import os
from typing import Optional, Tuple

import numpy as np
import torch

from ttrt_torch.scene import Skybox
from ttrt_torch.utils.profiling import touch_device

FACE_NAMES = ("+X", "-X", "+Y", "-Y", "+Z", "-Z")  # TerminalRayTracer.c:390


class AssetError(RuntimeError):
    """Raised on malformed/missing assets (the reference exits(1) instead:
    TerminalRayTracer.c:318-322, 327-332, 351-356, 363-368, 413-417)."""


def _read_header_token(buf: io.BufferedReader) -> bytes:
    """Read one whitespace-delimited header token, skipping ``#`` comments
    (TerminalRayTracer.c:335-339, generalized to any header position)."""
    token = b""
    while True:
        c = buf.read(1)
        if c == b"":
            raise AssetError("unexpected EOF in PPM header")
        if c == b"#":
            while c not in (b"\n", b""):
                c = buf.read(1)
            continue
        if c.isspace():
            if token:
                return token
            continue
        token += c


def read_ppm(path_or_bytes) -> np.ndarray:
    """Read a binary P6 PPM into a (height, width, 3) uint8 array."""
    if isinstance(path_or_bytes, (str, os.PathLike)):
        try:
            f = open(path_or_bytes, "rb")
        except OSError as e:
            raise AssetError(f"Error opening file {path_or_bytes}") from e
        with f:
            return _read_ppm_stream(io.BufferedReader(f))
    return _read_ppm_stream(io.BufferedReader(io.BytesIO(path_or_bytes)))


def _read_ppm_stream(buf) -> np.ndarray:
    if buf.read(2) != b"P6":
        raise AssetError("file is not ppm (P6 required)")
    try:
        width = int(_read_header_token(buf))
        height = int(_read_header_token(buf))
        maxval = int(_read_header_token(buf))
    except ValueError as e:
        raise AssetError("malformed PPM header") from e
    if maxval != 255:
        raise AssetError("max color value is not 255")
    data = buf.read(width * height * 3)
    if len(data) < width * height * 3:
        raise AssetError("truncated PPM pixel data")
    return np.frombuffer(data, np.uint8).reshape(height, width, 3)


def write_ppm(path: str, image: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 array as binary P6 (inverse of read_ppm)."""
    image = np.ascontiguousarray(image, dtype=np.uint8)
    h, w, _ = image.shape
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(image.tobytes())


def load_skybox_faces(directory: str) -> np.ndarray:
    """Load the six face PPMs of a directory into a (6, dim, dim, 3) uint8
    array (TerminalRayTracer.c:388-427)."""
    faces = []
    dim = -1
    for name in FACE_NAMES:
        img = read_ppm(os.path.join(directory, f"{name}.ppm"))
        h, w, _ = img.shape
        if dim == -1:
            dim = w
        if w != dim or h != dim:
            raise AssetError("all faces of the skybox must be the same size")
        faces.append(img)
    return np.stack(faces)


def skybox_from_faces(faces_u8: np.ndarray, *, device,
                      procedural: Optional[str] = None) -> Skybox:
    """(6, dim, dim, 3) uint8 -> packed 0x00RRGGBB Skybox on ``device``
    (packed in numpy, one host-to-device copy)."""
    f = np.asarray(faces_u8, np.int32)
    packed = (f[..., 0] << 16) | (f[..., 1] << 8) | f[..., 2]
    return Skybox(torch.as_tensor(packed, device=device), procedural)


def load_skybox(name_or_dir: str, *, device,
                search_dirs: Tuple[str, ...] = ("skybox", ".")) -> Skybox:
    """Load a named skybox (``skybox/<name>/{+X,..}.ppm``,
    TerminalRayTracer.c:403) or a faces directory; falls back to a
    procedural build for the known debug names if no files exist."""
    touch_device(device)
    candidates = [name_or_dir] + [
        os.path.join(d, name_or_dir) for d in search_dirs
    ]
    for c in candidates:
        if os.path.isdir(c):
            return skybox_from_faces(load_skybox_faces(c), device=device)
    base = os.path.basename(name_or_dir)
    gen = PROCEDURAL_SKYBOXES.get(base)
    if gen is None:
        raise AssetError(f"Error opening skybox {name_or_dir}")
    # 'colors' and 'uv_checker' have exact in-kernel evaluations; tag them
    tag = base if base in ("colors", "uv_checker") else None
    return skybox_from_faces(gen(), device=device, procedural=tag)


# ---------------------------------------------------------------------------
# Procedural cubemaps (verbatim from ttrt/assets.py)
# ---------------------------------------------------------------------------

def make_colors_skybox(dim: int = 256) -> np.ndarray:
    """Solid-color faces identical to the reference's ``skybox/colors``
    assets: +X red, -X cyan, +Y green, -Y magenta, +Z blue, -Z yellow."""
    face_colors = np.array(
        [
            [255, 0, 0],
            [0, 255, 255],
            [0, 255, 0],
            [255, 0, 255],
            [0, 0, 255],
            [255, 255, 0],
        ],
        np.uint8,
    )
    return np.broadcast_to(
        face_colors[:, None, None, :], (6, dim, dim, 3)
    ).copy()


def make_uv_checker_skybox(dim: int = 256, squares: int = 8) -> np.ndarray:
    """A uv-orientation debug cubemap: per-face hue with a checker whose
    brightness encodes (u, v)."""
    # all-float32 arithmetic, exactly mirroring the in-kernel evaluation
    # (ttrt_torch.kernels.render) so the kernel's sky is BIT-IDENTICAL to
    # these texels.
    f32 = np.float32
    face_hues = make_colors_skybox(1)[:, 0, 0, :].astype(f32) / f32(255)
    u = (np.arange(dim, dtype=f32) / f32(dim))
    uu = np.broadcast_to(u[None, :], (dim, dim))  # u along columns
    vv = np.broadcast_to(u[:, None], (dim, dim))  # v along rows
    checker = (
        (np.floor(uu * f32(squares)) + np.floor(vv * f32(squares))) % f32(2)
    ).astype(f32)
    shade = f32(0.25) + f32(0.5) * checker
    out = np.empty((6, dim, dim, 3), f32)
    for f in range(6):
        out[f, ..., 0] = np.clip(
            face_hues[f, 0] * shade + f32(0.3) * uu, f32(0), f32(1)
        )
        out[f, ..., 1] = np.clip(
            face_hues[f, 1] * shade + f32(0.3) * vv, f32(0), f32(1)
        )
        out[f, ..., 2] = face_hues[f, 2] * shade
    return (out * f32(255)).astype(np.uint8)


def make_starfield_skybox(dim: int = 256, density: float = 0.002,
                          seed: int = 20260816) -> np.ndarray:
    """Procedural night-sky stand-in for the reference's default (but
    stripped) ``milky_way`` cubemap (TerminalRayTracer.c:1244): dark blue
    base, a soft galactic band, white-ish stars."""
    rng = np.random.default_rng(seed)
    out = np.zeros((6, dim, dim, 3), np.float32)
    out[..., 2] = 0.035
    out[..., 0] = 0.01
    out[..., 1] = 0.015
    yy = np.linspace(-1.0, 1.0, dim)[:, None]
    band = np.exp(-(yy**2) * 8.0).astype(np.float32)
    for f in (0, 1, 4, 5):  # band wraps the horizontal faces
        out[f, :, :, 0] += 0.05 * band
        out[f, :, :, 1] += 0.05 * band
        out[f, :, :, 2] += 0.08 * band
    n_stars = int(density * dim * dim)
    for f in range(6):
        ys = rng.integers(0, dim, n_stars)
        xs = rng.integers(0, dim, n_stars)
        mag = rng.uniform(0.3, 1.0, n_stars).astype(np.float32)
        tint = rng.uniform(0.85, 1.0, (n_stars, 3)).astype(np.float32)
        out[f, ys, xs] = np.maximum(out[f, ys, xs], mag[:, None] * tint)
    return (np.clip(out, 0, 1) * 255).astype(np.uint8)


PROCEDURAL_SKYBOXES = {
    "colors": make_colors_skybox,
    "uv_checker": make_uv_checker_skybox,
    "milky_way": make_starfield_skybox,
    "starfield": make_starfield_skybox,
}
