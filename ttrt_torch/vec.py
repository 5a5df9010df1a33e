"""Struct-of-arrays 3-vector math (port of ``ttrt.vec``).

A batch of N 3-vectors is three same-shaped tensors rather than one
``(N, 3)`` tensor, as in the JAX package, so that the public functions of
both packages take and return the same layout.

Semantics mirror the reference vector library (TerminalRayTracer.c:438-546),
including its quirk: ``normalize`` is a no-op when the length is <= 1e-4
(TerminalRayTracer.c:444).

Division by a constant is written as division by a tensor: PyTorch's CUDA
``tensor / python_scalar`` multiplies by the rounded reciprocal, which is
not the IEEE quotient the JAX package computes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ttrt_torch.config import constants


def scalar_like(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a 0-dim tensor of ``like``'s dtype and device: Python's
    double is rounded once to the working dtype, as JAX's weak-typed
    scalars are, and division by it stays an IEEE division on the card."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Square root rounded to nearest, as JAX's and CUDA's are. PyTorch's
    CPU ``sqrt`` goes through a vector math library and is not correctly
    rounded (measured on one AVX-512 build: about 1% of float32 and float64
    results one ulp off, and in one process of a parallel test run float64
    results off by 2^18 ulps). So the root is taken in float64 and
    corrected once by the exact residual ``x - y*y`` (Dekker's product:
    every step below is exact in float64), which rounds it correctly; a
    float32 result is then rounded once from there, which is exact too."""
    x64 = x.double()
    y = torch.sqrt(x64)
    ok = y > 0
    ys = torch.where(ok, y, 1.0)
    p = ys * ys
    c = 134217729.0 * ys  # 2**27 + 1 splits ys into two 26-bit halves
    hi = c - (c - ys)
    lo = ys - hi
    err = ((hi * hi - p) + 2.0 * hi * lo) + lo * lo  # ys*ys == p + err
    y = torch.where(ok, ys + ((x64 - p) - err) / (2.0 * ys), y)
    return y.to(x.dtype)


class Vec3(NamedTuple):
    """Three same-shaped tensors acting as a batch of 3-vectors."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    @staticmethod
    def from_array(a: torch.Tensor) -> "Vec3":
        """From a trailing-dim-3 tensor."""
        return Vec3(a[..., 0], a[..., 1], a[..., 2])

    @staticmethod
    def full_like(v: "Vec3", x, y, z) -> "Vec3":
        """Each component filled with one value, shaped like ``v``'s."""
        return Vec3(torch.full_like(v.x, x), torch.full_like(v.y, y),
                    torch.full_like(v.z, z))

    def to_array(self) -> torch.Tensor:
        return torch.stack([self.x, self.y, self.z], dim=-1)

    def __add__(self, o: "Vec3") -> "Vec3":
        return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)

    def __sub__(self, o: "Vec3") -> "Vec3":
        return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)

    def __mul__(self, o) -> "Vec3":
        """Pointwise vector*vector or vector*scalar."""
        if isinstance(o, Vec3):
            return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)
        return Vec3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __neg__(self) -> "Vec3":
        return Vec3(-self.x, -self.y, -self.z)

    def dot(self, o: "Vec3") -> torch.Tensor:
        """TerminalRayTracer.c:461-464."""
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o: "Vec3") -> "Vec3":
        return Vec3(self.y * o.z - self.z * o.y,
                    self.z * o.x - self.x * o.z,
                    self.x * o.y - self.y * o.x)

    def reflect(self, normal: "Vec3") -> "Vec3":
        """v - 2 (v.n) n (TerminalRayTracer.c:626-633)."""
        d = 2.0 * self.dot(normal)
        return Vec3(self.x - d * normal.x, self.y - d * normal.y,
                    self.z - d * normal.z)

    def clamp(self, lo, hi) -> "Vec3":
        return Vec3(*(torch.clamp(c, lo, hi) for c in self))

    def where(self, mask, other: "Vec3") -> "Vec3":
        """Self where ``mask``, else ``other``."""
        return Vec3(*(torch.where(mask, a, b) for a, b in zip(self, other)))

    def length_sq(self) -> torch.Tensor:
        return self.dot(self)

    def length(self) -> torch.Tensor:
        return sqrt_rn(self.length_sq())

    def normalize(self) -> "Vec3":
        """Guarded normalize: identity when length <= 1e-4
        (TerminalRayTracer.c:439-450)."""
        length = self.length()
        ok = length > constants.NORMALIZE_GUARD
        inv = torch.where(ok, 1.0 / torch.where(ok, length, 1.0), 1.0)
        return Vec3(self.x * inv, self.y * inv, self.z * inv)


def triangle_wave(t: torch.Tensor) -> torch.Tensor:
    """Period-2*pi triangle wave in [0, 1]: 0->0, pi/2->1 ... the
    reference's deterministic AA jitter source (TerminalRayTracer.c:225-228).
    ``torch.remainder`` is floor-mod, as ``jnp.mod`` is."""
    pi = scalar_like(constants.PI, t)
    m = torch.remainder(t, scalar_like(2.0 * constants.PI, t))
    return torch.where(m < pi, m / pi, 2.0 - m / pi)
