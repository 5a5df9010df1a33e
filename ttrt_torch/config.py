"""Render configuration and reference constants (port of ``ttrt.config``).

The reference hard-codes these as ``#define``s (TerminalRayTracer.c:43-58);
here they are a runtime config so one build serves every resolution and
quality tier.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Constants:
    """Math/behavioral constants of the reference implementation.

    Values and provenance:
      - PI: TerminalRayTracer.c:43
      - EPSILON: self-intersection offset, TerminalRayTracer.c:44
      - NORMALIZE_GUARD: normalize is a no-op for ||v|| <= 1e-4
        (TerminalRayTracer.c:444)
      - PLANE_DENOM_EPS / PLANE_T_EPS: ray-plane rejection thresholds
        (TerminalRayTracer.c:680,685)
      - CONTRIBUTION_EPS: bounce-loop termination threshold
        (TerminalRayTracer.c:1018)
    """

    PI: float = 3.14159265358979323846
    EPSILON: float = 1e-6
    NORMALIZE_GUARD: float = 1e-4
    PLANE_DENOM_EPS: float = 1e-5
    PLANE_T_EPS: float = 1e-5
    CONTRIBUTION_EPS: float = 1e-5


constants = Constants()


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render parameters.

    Defaults mirror the reference (TerminalRayTracer.c:47-58): 480x280
    pixels, 10 AA rays per pixel, 10 bounce limit, 60 fps target.

    ``dtype`` is the torch compute dtype. The render kernels serve
    ``torch.float32`` only; the eager integrator (``render.integrator``)
    also computes in ``torch.float64``.

    ``skybox_bilinear`` asks for bilinear texel filtering (reference roadmap
    item, TerminalRayTracer.c:23); the port refuses it until that slice
    lands. ``specular`` switches on the Blinn-Phong term that the reference
    carries as commented-out code (TerminalRayTracer.c:913-916, 947-950).

    ``energy_model`` selects the bounce-mixing model:
      - ``"parity"`` (default): every hit adds its contribution-weighted
        shaded color and the pixel is normalized by the accumulated
        contribution total (TerminalRayTracer.c:1034-1061).
      - ``"subtract"``: the reference's roadmap model
        (TerminalRayTracer.c:24-28): a hit's local shading is weighted by
        (1 - reflectivity), the reflected continuation carries the rest,
        and no final normalization happens.
    """

    width: int = 480
    height: int = 280
    rays_per_pixel: int = 10
    bounce_limit: int = 10
    frame_rate: float = 60.0
    dtype: torch.dtype = torch.float32
    skybox_bilinear: bool = False
    specular: bool = False
    energy_model: str = "parity"

    def __post_init__(self):
        if self.energy_model not in ("parity", "subtract"):
            raise ConfigError(
                f"energy_model must be 'parity' or 'subtract', "
                f"got {self.energy_model!r}"
            )

    @property
    def frame_duration(self) -> float:
        return 1.0 / self.frame_rate

    def with_(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


class ConfigError(ValueError):
    """A user-configuration refusal (renderer/extension constraints). The
    CLI catches this (and AssetError) to print a one-line error; internal
    ValueErrors still traceback."""
