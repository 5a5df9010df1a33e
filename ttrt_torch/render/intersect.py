"""Ray-scene intersection of the eager integrator: batched primitive tests
and the nearest-hit scan of the demo scene (port of
``ttrt.render.intersect``).

Parity notes (each mirrors a quirk of the reference):
  - sphere hit iff discriminant >= 0 and nearer root t0 > 0
    (TerminalRayTracer.c:650-671); the far root is never used.
  - plane hit iff |denom| > 1e-5 and t > 1e-5 (TerminalRayTracer.c:680,685).
  - the nearest object is chosen by SQUARED distance from the ray origin,
    dot(o - p, o - p) (TerminalRayTracer.c:809-816), strictly less-than,
    spheres first, then the ground.
  - checker parity ((int)(floor(x) + floor(z))) & 1 (TerminalRayTracer.c:850).
  - on a hit the point is pushed EPSILON back toward the ray origin through
    a guarded normalize (TerminalRayTracer.c:870-874); on a miss point =
    origin, normal = direction, material = sky color with reflectivity and
    specularity 0 (TerminalRayTracer.c:858-867).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ttrt_torch.config import constants
from ttrt_torch.render.skybox import sample_skybox
from ttrt_torch.scene import (HIT_GROUND, HIT_NONE, HIT_SPHERE, Materials,
                              Scene)
from ttrt_torch.vec import Vec3, scalar_like, sqrt_rn


class Hit(NamedTuple):
    """Per-ray nearest-hit record (outputs of trace_ray,
    TerminalRayTracer.c:793)."""

    kind: torch.Tensor  # int32 HIT_* tag
    point: Vec3  # EPSILON-offset on hits
    normal: Vec3  # guarded-normalized
    material: Materials  # per ray (sky material on a miss)


def ray_sphere_t0(o: Vec3, d: Vec3, center: Vec3,
                  radius) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearer quadratic root and hit mask (TerminalRayTracer.c:638-672);
    t0 is garbage where ``hit`` is False."""
    oc = o - center
    a = d.dot(d)
    b = 2.0 * oc.dot(d)
    c = oc.dot(oc) - radius * radius
    disc = b * b - 4.0 * a * c
    t0 = (-b - sqrt_rn(torch.clamp_min(disc, 0.0))) / (2.0 * a)
    return t0, (disc >= 0.0) & (t0 > 0.0)


def ray_plane_t(o: Vec3, d: Vec3, plane_point: Vec3, plane_normal: Vec3):
    """Plane intersection t and hit mask (TerminalRayTracer.c:677-695)."""
    denom = d.dot(plane_normal)
    safe = torch.where(denom == 0.0, 1.0, denom)
    t = (plane_point - o).dot(plane_normal) / safe
    hit = (torch.abs(denom) > constants.PLANE_DENOM_EPS) & (
        t > constants.PLANE_T_EPS)
    return t, hit


class _Best(NamedTuple):
    sqdist: torch.Tensor
    kind: torch.Tensor
    point: Vec3
    normal: Vec3
    color: Vec3
    reflectivity: torch.Tensor
    specularity: torch.Tensor


def _consider(best: _Best, hit, sqdist, kind_val, point, normal, color,
              refl, spec) -> _Best:
    """Masked running-min update: adopt the candidate where it hits
    strictly closer (TerminalRayTracer.c:816, 840)."""
    take = hit & (sqdist < best.sqdist)
    w = lambda a, b: torch.where(take, a, b)  # noqa: E731
    return _Best(w(sqdist, best.sqdist), w(kind_val, best.kind),
                 point.where(take, best.point),
                 normal.where(take, best.normal),
                 color.where(take, best.color),
                 w(refl, best.reflectivity), w(spec, best.specularity))


def nearest_hit_raw(scene: Scene, o: Vec3, d: Vec3) -> _Best:
    """Scan all objects, spheres then ground, and return the raw closest
    hit (before the miss fixups and the normalize)."""
    zero = torch.zeros_like(o.x)
    zero3 = Vec3(zero, zero, zero)
    best = _Best(torch.full_like(o.x, torch.inf),
                 torch.zeros_like(o.x, dtype=torch.int32), zero3, zero3,
                 zero3, zero, zero)
    sph = scene.spheres
    for i in range(sph.count):
        center = Vec3(*(c[i] for c in sph.center))
        t0, hit = ray_sphere_t0(o, d, center, sph.radius[i])
        point = Vec3(o.x + t0 * d.x, o.y + t0 * d.y, o.z + t0 * d.z)
        to_point = o - point
        m = sph.material
        best = _consider(best, hit, to_point.dot(to_point), HIT_SPHERE,
                         point, point - center,
                         zero3 + Vec3(*(c[i] for c in m.color)),
                         m.reflectivity[i], m.specularity[i])

    # ground plane (TerminalRayTracer.c:830-853)
    g = scene.ground
    t, hit = ray_plane_t(o, d, g.point, g.normal)
    point = Vec3(o.x + t * d.x, o.y + t * d.y, o.z + t * d.z)
    to_point = o - point
    parity = (torch.floor(point.x) + torch.floor(point.z)).to(torch.int32) & 1
    odd = parity == 1
    e, od = g.even_material, g.odd_material
    col = Vec3(*(torch.where(odd, a, b) for a, b in zip(od.color, e.color)))
    refl = torch.where(odd, od.reflectivity, e.reflectivity)
    spec = torch.where(odd, od.specularity, e.specularity)
    return _consider(best, hit, to_point.dot(to_point), HIT_GROUND, point,
                     zero3 + g.normal, col, refl, spec)


def trace_ray(scene: Scene, o: Vec3, d: Vec3, *, sample_sky: bool = True,
              bilinear: bool = False) -> Hit:
    """Full trace_ray semantics (TerminalRayTracer.c:793-889) over a ray
    batch. ``sample_sky=False`` skips the sky gather (shadow rays never
    read the material, TerminalRayTracer.c:907,937)."""
    best = nearest_hit_raw(scene, o, d)
    miss = best.kind == HIT_NONE
    to_origin = (o - best.point).normalize()
    eps = scalar_like(constants.EPSILON, o.x)
    point_hit = Vec3(best.point.x + to_origin.x * eps,
                     best.point.y + to_origin.y * eps,
                     best.point.z + to_origin.z * eps)
    point = o.where(miss, point_hit)
    normal = d.where(miss, best.normal).normalize()
    color = best.color
    if sample_sky:
        color = sample_skybox(scene.skybox, d, bilinear=bilinear).where(
            miss, color)
    return Hit(best.kind, point, normal,
               Materials(color, torch.where(miss, 0.0, best.reflectivity),
                         torch.where(miss, 0.0, best.specularity)))


# the demo Scene traces through the linear object scan above
from ttrt_torch.render import dispatch as _dispatch  # noqa: E402

_dispatch.register_trace(Scene, trace_ray)
