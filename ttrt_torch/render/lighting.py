"""Lambertian diffuse lighting with shadow rays, per the reference's
apply_lighting (TerminalRayTracer.c:891-963); port of
``ttrt.render.lighting``.

Parity quirks kept: n.l is clamped above at 1 but not below at 0
(TerminalRayTracer.c:911,945); directional lights are blocked by any hit of
the shadow ray; a point light is lit when the shadow trace misses or its
blocker is farther than the light (TerminalRayTracer.c:937-942); the sum is
clamped to [0, 1] (TerminalRayTracer.c:960). The Blinn-Phong term, which the
reference carries as commented-out code (TerminalRayTracer.c:913-916,
947-950), is on with ``specular=True``.
"""

from __future__ import annotations

import torch

from ttrt_torch.render import dispatch
from ttrt_torch.scene import HIT_NONE
from ttrt_torch.vec import Vec3


def _clamp(v, lo, hi):
    return torch.minimum(torch.maximum(v, torch.full_like(v, lo)),
                         torch.full_like(v, hi))


def apply_lighting(scene, intersection: Vec3, view: Vec3, normal: Vec3,
                   material_color: Vec3, specularity=None, *,
                   specular: bool = False) -> Vec3:
    """Shade a batch of hit points; returns the lit color."""
    zero = torch.zeros_like(intersection.x)
    out = Vec3(zero, zero, zero)
    zero3 = out

    dl = scene.directional_lights
    for i in range(dl.count):
        ldir = Vec3(-dl.direction.x[i], -dl.direction.y[i],
                    -dl.direction.z[i]).normalize()
        ldir_b = zero3 + ldir
        shadow = dispatch.trace(scene, intersection, ldir_b,
                                sample_sky=False)
        unblocked = shadow.kind == HIT_NONE
        ndotl = torch.clamp_max(normal.dot(ldir_b), 1.0)  # c:911
        lcol = Vec3(dl.color.x[i], dl.color.y[i], dl.color.z[i])
        contrib = Vec3(lcol.x * ndotl * material_color.x,
                       lcol.y * ndotl * material_color.y,
                       lcol.z * ndotl * material_color.z)
        if specular and specularity is not None:
            half = (ldir_b + view).normalize()
            s = torch.pow(_clamp(normal.dot(half), 0.0, 1.0), specularity)
            contrib = Vec3(contrib.x + lcol.x * s, contrib.y + lcol.y * s,
                           contrib.z + lcol.z * s)
        out = out + contrib.where(unblocked, zero3)

    pls = scene.point_lights
    for i in range(pls.count):
        lpos = Vec3(pls.position.x[i], pls.position.y[i], pls.position.z[i])
        lvec = lpos - intersection
        light_d2 = lvec.dot(lvec)
        intensity = _clamp(pls.intensity[i] / light_d2, 0.0, 1.0)  # c:931
        ldir = lvec.normalize()
        shadow = dispatch.trace(scene, intersection, ldir, sample_sky=False)
        # blocker distance^2 from the EPSILON-offset shadow hit; a miss's
        # point is the origin, but the kind == NONE arm decides first
        to_block = shadow.point - intersection
        lit = (shadow.kind == HIT_NONE) | (light_d2 < to_block.dot(to_block))
        scale = intensity * torch.clamp_max(normal.dot(ldir), 1.0)  # c:945
        lcol = Vec3(pls.color.x[i], pls.color.y[i], pls.color.z[i])
        contrib = Vec3(lcol.x * scale * material_color.x,
                       lcol.y * scale * material_color.y,
                       lcol.z * scale * material_color.z)
        if specular and specularity is not None:
            half = (ldir + view).normalize()
            s = intensity * torch.pow(
                _clamp(normal.dot(half), 0.0, 1.0), specularity)
            contrib = Vec3(contrib.x + lcol.x * s, contrib.y + lcol.y * s,
                           contrib.z + lcol.z * s)
        out = out + contrib.where(lit, zero3)

    return out.clamp(0.0, 1.0)  # TerminalRayTracer.c:960
