"""The demo scene (TerminalRayTracer.c:1256-1306) and its trace, the
linear nearest-object scan (trace_ray, TerminalRayTracer.c:793-889):

- a sphere is hit iff the discriminant is >= 0 and the nearer root t0 > 0
  (the far root is never used);
- the plane is hit iff |denom| > 1e-5 and t > 1e-5;
- the nearest object is chosen by the SQUARED distance from the origin,
  strictly less-than, spheres first, then the ground;
- checker parity ((int)(floor(x) + floor(z))) & 1;
- a hit point is pushed EPSILON back toward the origin through a guarded
  normalize; a miss keeps point = origin and normal = direction.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference.scene import (HIT_GROUND, HIT_NONE, HIT_SPHERE, Hit,
                                       Lights, Spheres, lights, vec_of)
from benchmark.reference.vec import (EPSILON, PLANE_DENOM_EPS, PLANE_T_EPS,
                                     Vec3, scalar_like, sqrt_rn)

CENTERS = [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0],
           [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0], [0.0, 0.0, -1.0]]
COLORS = [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0],
          [0.0, 1.0, 1.0], [1.0, 0.0, 1.0], [1.0, 1.0, 0.0]]
REFLECTIVITY = [1.0, 0.8, 0.8, 0.8, 0.8, 0.8]
RADIUS = 0.5
GROUND_Y = -2.0
EVEN_COLOR, ODD_COLOR, GROUND_REFLECTIVITY = (1.0, 1.0, 1.0), \
    (1.0, 0.0, 0.0), 0.2


class DemoScene(NamedTuple):
    spheres: Spheres
    ground_point: Vec3  # 0-dim components
    ground_normal: Vec3
    even_color: Vec3
    odd_color: Vec3
    ground_reflectivity: torch.Tensor
    lights: Lights

    def trace(self, o: Vec3, d: Vec3) -> Hit:
        return trace(self, o, d)


def build(config: dict, *, dtype, device) -> DemoScene:
    """The demo scene."""
    kw = dict(dtype=dtype, device=device)
    s = lambda v: torch.tensor(v, **kw)  # noqa: E731
    v = lambda x, y, z: Vec3(s(x), s(y), s(z))  # noqa: E731
    spheres = Spheres(vec_of(CENTERS, **kw),
                      torch.as_tensor(np.full((6,), RADIUS), **kw),
                      vec_of(COLORS, **kw),
                      torch.as_tensor(np.asarray(REFLECTIVITY), **kw))
    return DemoScene(spheres, v(0.0, GROUND_Y, 0.0), v(0.0, 1.0, 0.0),
                     v(*EVEN_COLOR), v(*ODD_COLOR), s(GROUND_REFLECTIVITY),
                     lights([-1.0, -1.0, -1.0], [0.0, 0.0, 0.0], **kw))


def sphere_t0(o: Vec3, d: Vec3, center: Vec3, radius):
    """The nearer quadratic root and the hit mask
    (TerminalRayTracer.c:638-672)."""
    oc = o - center
    a = d.dot(d)
    b = 2.0 * oc.dot(d)
    c = oc.dot(oc) - radius * radius
    disc = b * b - 4.0 * a * c
    t0 = (-b - sqrt_rn(torch.clamp_min(disc, 0.0))) / (2.0 * a)
    return t0, (disc >= 0.0) & (t0 > 0.0)


def trace(scene: DemoScene, o: Vec3, d: Vec3) -> Hit:
    zero = torch.zeros_like(o.x)
    zero3 = Vec3(zero, zero, zero)
    best_sq = torch.full_like(o.x, torch.inf)
    kind = torch.zeros_like(o.x, dtype=torch.int32)
    point, normal, color, refl = zero3, zero3, zero3, zero

    def consider(hit, sqdist, kind_val, p, n, c, r):
        nonlocal best_sq, kind, point, normal, color, refl
        take = hit & (sqdist < best_sq)
        best_sq = torch.where(take, sqdist, best_sq)
        kind = torch.where(take, kind_val, kind)
        point, normal = p.where(take, point), n.where(take, normal)
        color, refl = c.where(take, color), torch.where(take, r, refl)

    sph = scene.spheres
    for i in range(sph.count):
        center = sph.center.take(i)
        t0, hit = sphere_t0(o, d, center, sph.radius[i])
        p = Vec3(o.x + t0 * d.x, o.y + t0 * d.y, o.z + t0 * d.z)
        to_p = o - p
        consider(hit, to_p.dot(to_p), HIT_SPHERE, p, p - center,
                 zero3 + sph.color.take(i), sph.reflectivity[i])

    n = scene.ground_normal
    denom = d.dot(n)
    safe = torch.where(denom == 0.0, 1.0, denom)
    t = (scene.ground_point - o).dot(n) / safe
    hit = (torch.abs(denom) > PLANE_DENOM_EPS) & (t > PLANE_T_EPS)
    p = Vec3(o.x + t * d.x, o.y + t * d.y, o.z + t * d.z)
    to_p = o - p
    odd = ((torch.floor(p.x) + torch.floor(p.z)).to(torch.int32) & 1) == 1
    col = Vec3(*(torch.where(odd, a, b)
                 for a, b in zip(scene.odd_color, scene.even_color)))
    consider(hit, to_p.dot(to_p), HIT_GROUND, p, zero3 + n, col,
             torch.where(odd, scene.ground_reflectivity,
                         scene.ground_reflectivity))

    miss = kind == HIT_NONE
    to_origin = (o - point).normalize()
    eps = scalar_like(EPSILON, o.x)
    p_hit = Vec3(point.x + to_origin.x * eps, point.y + to_origin.y * eps,
                 point.z + to_origin.z * eps)
    return Hit(kind, o.where(miss, p_hit), d.where(miss, normal).normalize(),
               color, torch.where(miss, 0.0, refl))
