"""The port's binding to the native host runtime (``ttrt_torch.native``,
built from csrc/ttrt_native.c into ttrt_torch/_build/) against the NumPy
encoder and against the JAX package's binding to the same source:
tests/test_native.py's checks on the port (and the display's
``write_rgb_frame``), and the encoders' bytes equal across both packages
on seeded frames."""

import io
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from ttrt import native as jax_native

from ttrt_torch import native
from ttrt_torch.term.display import TerminalDisplay
from ttrt_torch.term.encoder import ansi_buffer_size, encode_ansi_host

torch.set_num_threads(1)  # the test workers share the cores


REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _library():
    if not native.available:
        pytest.skip("no C compiler for the native library")


def _frames(seed, shape, n=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, shape, dtype=np.uint8) for _ in range(n)]


def test_native_encoder_matches_host_encoder():
    (rgb,) = _frames(11, (13, 29, 3))
    out = native.NativeAnsiEncoder(13, 29).encode(rgb)
    assert out.tobytes() == encode_ansi_host(rgb)
    sink = io.BytesIO()
    assert TerminalDisplay(sink).write_rgb_frame(rgb) == len(out)
    assert sink.getvalue() == out.tobytes()


def test_native_size_matches():
    assert native.NativeAnsiEncoder(7, 5).size == ansi_buffer_size(5, 7)


def test_template_reuse_across_frames():
    enc = native.NativeAnsiEncoder(4, 6)
    for rgb in _frames(12, (4, 6, 3), n=3):
        assert enc.encode(rgb).tobytes() == encode_ansi_host(rgb)


def test_write_full(tmp_path):
    enc = native.NativeAnsiEncoder(2, 2)
    rgb = np.zeros((2, 2, 3), np.uint8)
    enc.encode(rgb)
    path = tmp_path / "frame.bin"
    fd = os.open(path, os.O_WRONLY | os.O_CREAT)
    try:
        enc.write(fd)
        native.write_full(fd, b"tail")
    finally:
        os.close(fd)
    assert path.read_bytes() == encode_ansi_host(rgb) + b"tail"


def test_sleep_until_is_absolute():
    t0 = native.monotonic()
    native.sleep_until(t0 + 0.05)
    assert native.monotonic() - t0 >= 0.045


def test_sleep_until_past_deadline_returns_immediately():
    t0 = native.monotonic()
    native.sleep_until(t0 - 1.0)
    assert native.monotonic() - t0 < 0.05


@pytest.mark.parametrize("shape", [(13, 29, 3), (28, 48, 3), (1, 1, 3)])
def test_encoder_bytes_equal_jax_native(shape):
    """The port's encoder, JAX's ``ttrt.native.NativeAnsiEncoder`` and the
    port's NumPy encoder give the same bytes on seeded frames."""
    if not jax_native.available:
        pytest.skip("the JAX package's native library did not build")
    h, w, _ = shape
    port = native.NativeAnsiEncoder(h, w)
    ref = jax_native.NativeAnsiEncoder(h, w)
    for rgb in _frames(13, shape, n=2):
        got = port.encode(rgb).tobytes()
        assert got == ref.encode(rgb).tobytes()
        assert got == encode_ansi_host(rgb)


def test_library_lives_in_the_ports_build_directory():
    path = Path(native.library_path)
    assert path.parent == REPO / "ttrt_torch" / "_build"
    assert path.name.startswith("libttrt_native_") and path.is_file()
    assert Path(jax_native._LIB_PATH).resolve() != path.resolve()
