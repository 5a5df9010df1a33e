"""The demo's orbit camera (TerminalRayTracer.c:1326-1336) and the screen
(TerminalRayTracer.c:298-305): the pose a pure function of the scene
time, with the source's transposed ``rotate_basis`` (B @ R.T) and its
row-vector frame composition. The 3x3 products are written out
elementwise."""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference.vec import PI, scalar_like


class Camera(NamedTuple):
    """A pinhole camera: basis (3, 3) with rows = axes, origin (3,), the
    screen 1 m away and 5*(W/H) x 5 m."""

    basis: torch.Tensor
    origin: torch.Tensor
    screen_distance: torch.Tensor
    screen_width: torch.Tensor
    screen_height: torch.Tensor


def _matmul3(a, b):
    return (a[..., 0, None] * b[0] + a[..., 1, None] * b[1]
            + a[..., 2, None] * b[2])


def _rotation(angle, axis: int):
    c, s = torch.cos(angle), torch.sin(angle)
    one, zero = torch.ones_like(angle), torch.zeros_like(angle)
    rows = {0: [[one, zero, zero], [zero, c, -s], [zero, s, c]],
            1: [[c, zero, s], [zero, one, zero], [-s, zero, c]]}[axis]
    return torch.stack([torch.stack(r) for r in rows])


def _rotate(basis, angle, axis: int):
    angle = torch.as_tensor(angle, dtype=basis.dtype, device=basis.device)
    return _matmul3(basis, _rotation(angle, axis).T)


def orbit_camera(t: float, width: int, height: int, *, dtype,
                 device) -> Camera:
    """The camera at scene time ``t`` (seconds, rounded once to
    ``dtype``): radius 1.99 m about the origin, spun by
    Rx(2 pi t * -0.03) then Ry(2 pi t * 0.05)."""
    t = torch.full((), t, dtype=dtype, device=device)
    two_pi = scalar_like(2.0 * PI, t)
    b0 = torch.eye(3, dtype=dtype, device=device)
    b0 = _rotate(b0, two_pi * t * (-0.03), 0)
    b0 = _rotate(b0, two_pi * t * 0.05, 1)
    eye = torch.eye(3, dtype=dtype, device=device)
    # identity, then the 1.99 m translation, then the spin
    basis = _matmul3(eye, eye)
    origin = _matmul3(torch.zeros(3, dtype=dtype, device=device), eye) \
        + eye[2] * 1.99
    basis, origin = _matmul3(basis, b0), _matmul3(origin, b0) + torch.zeros(
        3, dtype=dtype, device=device)
    s = lambda v: torch.tensor(v, dtype=dtype, device=device)  # noqa: E731
    return Camera(basis, origin, s(1.0), s(5.0 * width / height), s(5.0))
