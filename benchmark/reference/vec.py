"""3-vector math of the reference, with the source program's constants
(TerminalRayTracer.c:43-58, 438-546): a batch of 3-vectors is three
same-shaped tensors; ``normalize`` is a no-op for lengths <= 1e-4.

Division by a constant is division by a 0-dim tensor of the working
dtype (``scalar_like``): on the card, ``tensor / python_scalar``
multiplies by a rounded reciprocal instead of dividing.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

PI = 3.14159265358979323846
EPSILON = 1e-6
NORMALIZE_GUARD = 1e-4
PLANE_DENOM_EPS = 1e-5
PLANE_T_EPS = 1e-5
CONTRIBUTION_EPS = 1e-5


def scalar_like(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` rounded once to ``like``'s dtype, as a 0-dim tensor."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Square root rounded to nearest: taken in float64, corrected once by
    the exact residual (Dekker's product), then rounded to ``x``'s dtype.
    The CPU's vectorised ``sqrt`` is not correctly rounded."""
    x64 = x.double()
    y = torch.sqrt(x64)
    ok = y > 0
    ys = torch.where(ok, y, 1.0)
    p = ys * ys
    c = 134217729.0 * ys
    hi = c - (c - ys)
    lo = ys - hi
    err = ((hi * hi - p) + 2.0 * hi * lo) + lo * lo
    y = torch.where(ok, ys + ((x64 - p) - err) / (2.0 * ys), y)
    return y.to(x.dtype)


def fma(a, b, c):
    """a*b + c rounded once to the operands' dtype: computed in float64,
    where the product of two float32 values is exact (the sum then rounds
    twice, which differs from one rounding only on exact ties)."""
    tensors = [v for v in (a, b, c) if isinstance(v, torch.Tensor)]

    def f64(v):
        return v.double() if isinstance(v, torch.Tensor) else v

    out = f64(a) * f64(b) + f64(c)
    if any(t.dtype == torch.float64 for t in tensors):
        return out
    return out.to(tensors[0].dtype)


def dot3(ax, ay, az, bx, by, bz):
    """ax*bx + ay*by + az*bz as fma(az, bz, fma(ax, bx, ay*by))."""
    return fma(az, bz, fma(ax, bx, ay * by))


def dot_zyx(ax, ay, az, bx, by, bz):
    """ax*bx + ay*by + az*bz as fma(az, bz, fma(ay, by, ax*bx))."""
    return fma(az, bz, fma(ay, by, ax * bx))


def normalize3(x, y, z):
    """Guarded normalize on the squared length, times the reciprocal of
    the correctly rounded root."""
    len2 = dot3(x, y, z, x, y, z)
    ok = len2 > NORMALIZE_GUARD * NORMALIZE_GUARD
    inv = torch.where(ok, 1.0 / sqrt_rn(torch.where(ok, len2, 1.0)), 1.0)
    return x * inv, y * inv, z * inv


class Vec3(NamedTuple):
    """Three same-shaped tensors acting as a batch of 3-vectors."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    def __add__(self, o: "Vec3") -> "Vec3":
        return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)

    def __sub__(self, o: "Vec3") -> "Vec3":
        return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)

    def __mul__(self, o) -> "Vec3":
        if isinstance(o, Vec3):
            return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)
        return Vec3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __neg__(self) -> "Vec3":
        return Vec3(-self.x, -self.y, -self.z)

    def dot(self, o: "Vec3") -> torch.Tensor:
        return self.x * o.x + self.y * o.y + self.z * o.z

    def reflect(self, n: "Vec3") -> "Vec3":
        """v - 2 (v.n) n (TerminalRayTracer.c:626-633)."""
        d = 2.0 * self.dot(n)
        return Vec3(self.x - d * n.x, self.y - d * n.y, self.z - d * n.z)

    def where(self, mask, other: "Vec3") -> "Vec3":
        return Vec3(*(torch.where(mask, a, b) for a, b in zip(self, other)))

    def take(self, idx) -> "Vec3":
        return Vec3(self.x[idx], self.y[idx], self.z[idx])

    def normalize(self) -> "Vec3":
        """Identity when the length is <= 1e-4 (TerminalRayTracer.c:444)."""
        length = sqrt_rn(self.dot(self))
        ok = length > NORMALIZE_GUARD
        inv = torch.where(ok, 1.0 / torch.where(ok, length, 1.0), 1.0)
        return Vec3(self.x * inv, self.y * inv, self.z * inv)


def triangle_wave(t: torch.Tensor) -> torch.Tensor:
    """Period-2*pi triangle wave in [0, 1] (TerminalRayTracer.c:225-228),
    with floor-mod."""
    pi = scalar_like(PI, t)
    m = torch.remainder(t, scalar_like(2.0 * PI, t))
    return torch.where(m < pi, m / pi, 2.0 - m / pi)
