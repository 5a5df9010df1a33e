"""Reference frames: bases, rotations, rigid-transform composition (port of
``ttrt.frames``).

A basis is a row-major 3x3 tensor whose ROWS are the frame's x/y/z axes,
the reference's ``Basis{Vector x,y,z}`` layout (TerminalRayTracer.c:91-97).
The reference's composition conventions are kept verbatim, because camera
animation parity depends on them:

  - ``rotate_basis(B, R)`` computes ``B @ R.T`` (TerminalRayTracer.c:557-573),
    so the standard rotation matrices apply a rotation by ``-angle``.
  - ``transform_frame(F, T)`` is a row-vector homogeneous compose:
    ``basis' = F.basis @ T.basis``, ``origin' = F.origin @ T.basis +
    T.origin`` (TerminalRayTracer.c:605-624).

The 3x3 products are written out elementwise. The JAX package forces full
f32 on them (``Precision.HIGHEST``), because the camera basis feeds every
primary ray; elementwise products stay full precision on any device,
whatever the TF32 settings.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ttrt_torch.config import constants
from ttrt_torch.vec import scalar_like


class Frame(NamedTuple):
    """Rigid frame: ``basis`` (3, 3) with rows = axis vectors; ``origin``
    (3,) (TerminalRayTracer.c:99-104)."""

    basis: torch.Tensor
    origin: torch.Tensor

    @staticmethod
    def identity(*, dtype: torch.dtype, device) -> "Frame":
        """Default orientation + zero origin (TerminalRayTracer.c:289-296)."""
        return Frame(torch.eye(3, dtype=dtype, device=device),
                     torch.zeros(3, dtype=dtype, device=device))


def _matmul3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for ``a`` of shape (..., 3) and ``b`` (3, 3), summed left
    to right over the contracted index."""
    return a[..., 0, None] * b[0] + a[..., 1, None] * b[1] + a[..., 2, None] * b[2]


def rotate_basis(basis: torch.Tensor, rotation: torch.Tensor) -> torch.Tensor:
    """``result[i][j] = basis_row_i . rotation_row_j`` = ``B @ R.T``
    (TerminalRayTracer.c:557-573)."""
    return _matmul3(basis, rotation.T)


def _rotation(angle: torch.Tensor, axis: int) -> torch.Tensor:
    c, s = torch.cos(angle), torch.sin(angle)
    one, zero = torch.ones_like(angle), torch.zeros_like(angle)
    rows = {
        0: [[one, zero, zero], [zero, c, -s], [zero, s, c]],
        1: [[c, zero, s], [zero, one, zero], [-s, zero, c]],
        2: [[c, -s, zero], [s, c, zero], [zero, zero, one]],
    }[axis]
    return torch.stack([torch.stack(r) for r in rows])


def _as_angle(basis: torch.Tensor, angle) -> torch.Tensor:
    return torch.as_tensor(angle, dtype=basis.dtype, device=basis.device)


def rotate_basis_x(basis: torch.Tensor, angle) -> torch.Tensor:
    """TerminalRayTracer.c:575-583."""
    return rotate_basis(basis, _rotation(_as_angle(basis, angle), 0))


def rotate_basis_y(basis: torch.Tensor, angle) -> torch.Tensor:
    """TerminalRayTracer.c:585-593."""
    return rotate_basis(basis, _rotation(_as_angle(basis, angle), 1))


def rotate_basis_z(basis: torch.Tensor, angle) -> torch.Tensor:
    """TerminalRayTracer.c:595-603."""
    return rotate_basis(basis, _rotation(_as_angle(basis, angle), 2))


def transform_frame(frame: Frame, transform: Frame) -> Frame:
    """Row-vector homogeneous composition (TerminalRayTracer.c:605-624)."""
    return Frame(
        basis=_matmul3(frame.basis, transform.basis),
        origin=_matmul3(frame.origin, transform.basis) + transform.origin,
    )


def orbit_camera_frame(t, *, dtype: torch.dtype, device) -> Frame:
    """The demo's camera pose as a pure function of elapsed seconds
    (TerminalRayTracer.c:1326-1336): the camera orbits the origin at radius
    1.99 m, spun by Rx(2*pi*t*-0.03) then Ry(2*pi*t*0.05) through the
    reference's transposed ``rotate_basis``. ``t`` may be a float or a
    0-dim tensor; the pose is computed on ``device`` with no copy from
    the host."""
    if isinstance(t, torch.Tensor):
        t = t.to(dtype=dtype, device=device)
    else:  # a fill, not a host-to-device copy
        t = torch.full((), t, dtype=dtype, device=device)
    two_pi = scalar_like(2.0 * constants.PI, t)
    b0 = torch.eye(3, dtype=dtype, device=device)
    b0 = rotate_basis_x(b0, two_pi * t * (-0.03))
    b0 = rotate_basis_y(b0, two_pi * t * 0.05)
    tf0 = Frame(b0, torch.zeros(3, dtype=dtype, device=device))
    eye = torch.eye(3, dtype=dtype, device=device)
    tf1 = Frame(eye, eye[2] * 1.99)
    cam = Frame.identity(dtype=dtype, device=device)
    cam = transform_frame(cam, tf1)
    return transform_frame(cam, tf0)
