"""Batched GJK distance queries between convex bodies (port of
``ttrt.physics.gjk``).

Every pair of a batch runs in lockstep: the simplex is a fixed set of
four points a lane, the distance subalgorithm (the closest point to the
origin on a k-simplex) is straight-line barycentric arithmetic with
``where``-selects over the simplex size, and a converged lane stops
changing under a mask. Shapes are support functions: a sphere is a point
core plus a radius margin (exact in one iteration), a convex polytope an
argmax-dot over its vertices.

The public entry is ``gjk_distance(sa, sb, x0)``: the signed distance
(negative = penetrating) and the unit direction from B toward A, which
physics uses as the contact normal.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

from ttrt_torch.vec import Vec3, sqrt_rn

_EPS = 1e-10
MAX_ITERS = 20


class Support(NamedTuple):
    """A batch of convex bodies as a support function and a margin.

    ``fn(d: Vec3) -> Vec3`` maps a batch of directions to each body's
    farthest CORE point along it; ``margin`` (per lane) inflates the core
    by a sphere (0 for hard polytopes, the radius for spheres)."""

    fn: Callable[[Vec3], Vec3]
    margin: torch.Tensor


def sphere_support(center: Vec3, radius) -> Support:
    """A sphere: a point core and a radius margin."""
    def fn(d: Vec3) -> Vec3:
        return Vec3(*(c.expand_as(dc) for c, dc in zip(center, d)))

    return Support(fn, torch.as_tensor(radius))


def polytope_support(verts: torch.Tensor) -> Support:
    """A convex polytope from its vertices (..., V, 3): the support is the
    vertex of the largest dot product (the first of equal ones, as
    ``jnp.argmax`` picks)."""
    vx, vy, vz = verts[..., 0], verts[..., 1], verts[..., 2]

    def fn(d: Vec3) -> Vec3:
        dots = vx * d.x[..., None] + vy * d.y[..., None] + vz * d.z[..., None]
        i = torch.argmax(dots, dim=-1, keepdim=True)
        return Vec3(*(torch.gather(v, -1, i)[..., 0] for v in (vx, vy, vz)))

    return Support(fn, torch.zeros(verts.shape[:-2], dtype=verts.dtype,
                                   device=verts.device))


def _safe(den: torch.Tensor) -> torch.Tensor:
    """A denominator, 1 where it is within _EPS of 0."""
    return torch.where(den.abs() < _EPS, 1.0, den)


def _lerp(p: Vec3, t: torch.Tensor, e: Vec3) -> Vec3:
    """p + t e."""
    return Vec3(p.x + t * e.x, p.y + t * e.y, p.z + t * e.z)


def _closest_simplex(pts, size):
    """The closest point to the origin on a simplex of ``size`` (1..4)
    points.

    pts: 4 Vec3 (unused slots arbitrary). Returns (closest Vec3, new pts,
    new size): the supporting sub-simplex is compacted to the front. Every
    case is computed and selected by size, so lanes never branch."""
    a, b, c, d = pts

    # --- size 1: the point itself
    c1 = a

    # --- size 2: segment ab
    ab = b - a
    t = -a.dot(ab) / torch.clamp_min(ab.dot(ab), _EPS)
    t = torch.clamp(t, 0.0, 1.0)
    c2 = _lerp(a, t, ab)
    size2 = torch.where(t > 0.0, torch.where(t < 1.0, 2, 1), 1)
    # compact: if t == 1 the support is just b; if t == 0 just a
    first2 = b.where(t >= 1.0, a)
    second2 = b

    # --- size 3: triangle abc (barycentric region test)
    ab3 = b - a
    ac3 = c - a
    d1 = ab3.dot(-a)
    d2 = ac3.dot(-a)
    d3 = ab3.dot(-b)
    d4 = ac3.dot(-b)
    d5 = ab3.dot(-c)
    d6 = ac3.dot(-c)

    vc = d1 * d4 - d3 * d2
    vb = d5 * d2 - d1 * d6
    va = d3 * d6 - d5 * d4

    in_a = (d1 <= 0.0) & (d2 <= 0.0)  # vertex regions
    in_b = (d3 >= 0.0) & (d4 <= d3)
    in_c = (d6 >= 0.0) & (d5 <= d6)
    in_ab = (vc <= 0.0) & (d1 >= 0.0) & (d3 <= 0.0)  # edge regions
    in_ac = (vb <= 0.0) & (d2 >= 0.0) & (d6 <= 0.0)
    in_bc = (va <= 0.0) & (d4 - d3 >= 0.0) & (d5 - d6 >= 0.0)

    t_ab = d1 / _safe(d1 - d3)
    t_ac = d2 / _safe(d2 - d6)
    t_bc = (d4 - d3) / _safe((d4 - d3) + (d5 - d6))
    denom = _safe(va + vb + vc)
    v_b = vb / denom
    v_c = vc / denom

    p_ab = _lerp(a, t_ab, ab3)
    p_ac = _lerp(a, t_ac, ac3)
    p_bc = _lerp(b, t_bc, c - b)
    p_face = Vec3(a.x + v_b * ab3.x + v_c * ac3.x,
                  a.y + v_b * ab3.y + v_c * ac3.y,
                  a.z + v_b * ab3.z + v_c * ac3.z)

    # select by priority: vertices over edges over the face interior
    c3 = p_face
    f3_1, f3_2, f3_3 = a, b, c
    s3 = torch.full_like(d1, 3, dtype=torch.int32)
    for cond, point, p1, p2, sz in ((in_bc, p_bc, b, c, 2),
                                    (in_ac, p_ac, a, c, 2),
                                    (in_ab, p_ab, a, b, 2),
                                    (in_c, c, c, c, 1),
                                    (in_b, b, b, b, 1),
                                    (in_a, a, a, a, 1)):
        c3 = point.where(cond, c3)
        f3_1 = p1.where(cond, f3_1)
        f3_2 = p2.where(cond, f3_2)
        s3 = torch.where(cond, sz, s3)

    # --- size 4: tetrahedron. Test the origin against the 4 faces: inside
    # all, distance 0; else the nearest separating face's triangle case
    # (computed for every face, selected by distance).
    def tri_closest(p, q, r):
        # the closest point on triangle pqr to the origin (the size-3 math)
        e1 = q - p
        e2 = r - p
        dd1 = e1.dot(-p)
        dd2 = e2.dot(-p)
        dd3 = e1.dot(-q)
        dd4 = e2.dot(-q)
        dd5 = e1.dot(-r)
        dd6 = e2.dot(-r)
        vvc = dd1 * dd4 - dd3 * dd2
        vvb = dd5 * dd2 - dd1 * dd6
        vva = dd3 * dd6 - dd5 * dd4
        pa = (dd1 <= 0.0) & (dd2 <= 0.0)
        pb = (dd3 >= 0.0) & (dd4 <= dd3)
        pc = (dd6 >= 0.0) & (dd5 <= dd6)
        tt_ab = dd1 / _safe(dd1 - dd3)
        tt_ac = dd2 / _safe(dd2 - dd6)
        tt_bc = (dd4 - dd3) / _safe((dd4 - dd3) + (dd5 - dd6))
        e_ab = (vvc <= 0.0) & (dd1 >= 0.0) & (dd3 <= 0.0)
        e_ac = (vvb <= 0.0) & (dd2 >= 0.0) & (dd6 <= 0.0)
        e_bc = (vva <= 0.0) & (dd4 - dd3 >= 0.0) & (dd5 - dd6 >= 0.0)
        den = _safe(vva + vvb + vvc)
        w_b = vvb / den
        w_c = vvc / den
        cp = Vec3(p.x + w_b * e1.x + w_c * e2.x,
                  p.y + w_b * e1.y + w_c * e2.y,
                  p.z + w_b * e1.z + w_c * e2.z)
        cp = _lerp(q, tt_bc, r - q).where(e_bc, cp)
        cp = _lerp(p, tt_ac, e2).where(e_ac, cp)
        cp = _lerp(p, tt_ab, e1).where(e_ab, cp)
        cp = r.where(pc, cp)
        cp = q.where(pb, cp)
        return p.where(pa, cp)

    def face_sep(p, q, r, opp):
        # separated iff the origin is on the other side than the 4th vertex
        n = (q - p).cross(r - p)
        return (n.dot(-p) * n.dot(opp - p)) < 0.0

    faces = ((a, b, c, d), (a, b, d, c), (a, c, d, b), (b, c, d, a))
    seps = [face_sep(*f) for f in faces]
    inside = ~(seps[0] | seps[1] | seps[2] | seps[3])

    inf = torch.full_like(a.x, float("inf"))
    c4 = best = None
    for (p, q, r, _), sep in zip(faces, seps):
        cp = tri_closest(p, q, r)
        dist = torch.where(sep, cp.dot(cp), inf)
        if c4 is None:  # face abc
            c4, (f4_1, f4_2, f4_3), best = cp, (p, q, r), dist
            continue
        cond = dist < best
        c4 = cp.where(cond, c4)
        f4_1 = p.where(cond, f4_1)
        f4_2 = q.where(cond, f4_2)
        f4_3 = r.where(cond, f4_3)
        best = torch.where(cond, dist, best)

    c4 = Vec3.full_like(a, 0.0, 0.0, 0.0).where(inside, c4)
    s4 = torch.where(inside, 4, 3)

    # --- select by the current size
    is1 = size == 1
    is2 = size == 2
    is3 = size == 3

    closest = c1.where(is1, c2.where(is2, c3.where(is3, c4)))
    n1 = a.where(is1, first2.where(is2, f3_1.where(is3, f4_1)))
    n2 = a.where(is1, second2.where(is2, f3_2.where(is3, f4_2)))
    n3 = a.where(is1, a.where(is2, f3_3.where(is3, f4_3)))
    nsize = torch.where(
        is1, 1, torch.where(is2, size2, torch.where(is3, s3, s4))
    ).to(torch.int32)
    return closest, (n1, n2, n3, a), nsize


def gjk_distance(sa: Support, sb: Support, x0: Vec3
                 ) -> Tuple[torch.Tensor, Vec3]:
    """The signed distance between the body batches A and B, and the
    separating direction (unit, from B toward A).

    ``x0``: an initial direction guess a lane (e.g. the centre difference;
    any nonzero vector). The distance is exact for separated or touching
    margin shapes; for core-penetrating pairs it is the (negative) margin
    overlap bound, exact for sphere margins.

    The loop stops once every lane has converged, as JAX's ``while_loop``
    tests ``all(done)``: one host sync an iteration, which on the card
    costs far less than running all ``MAX_ITERS`` iterations."""

    def minkowski_support(d: Vec3) -> Vec3:
        return sa.fn(d) - sb.fn(-d)

    shape = x0.x.shape
    device = x0.x.device
    d0 = x0.normalize()
    deg = d0.dot(d0) < 0.5  # a degenerate zero guess
    d0 = Vec3(torch.where(deg, 1.0, d0.x), torch.where(deg, 0.0, d0.y),
              torch.where(deg, 0.0, d0.z))
    w0 = minkowski_support(d0)

    p1 = p2 = p3 = p4 = closest = w0
    size = torch.ones(shape, dtype=torch.int32, device=device)
    done = torch.zeros(shape, dtype=torch.bool, device=device)
    for it in range(MAX_ITERS):
        if it > 0 and bool(done.all()):
            break
        v = closest
        vlen2 = v.dot(v)
        # the new support toward the origin
        w = minkowski_support(-v)
        # converged: no significant progress toward the origin
        progress = vlen2 - v.dot(w)
        done_now = (done | (progress <= 1e-7 * torch.clamp_min(vlen2, 1.0))
                    | (vlen2 < 1e-12))

        # insert w at the front (the subalgorithm ignores the order)
        q4 = p3
        qsize = torch.clamp_max(size + 1, 4)
        new, (r1, r2, r3, _), rsize = _closest_simplex((w, p1, p2, p3),
                                                       qsize)

        upd = ~done_now
        p1, p2, p3 = r1.where(upd, p1), r2.where(upd, p2), r3.where(upd, p3)
        p4 = q4.where(upd, p4)
        size = torch.where(upd, rsize, size)
        closest = new.where(upd, closest)
        done = done_now | (rsize == 4) & upd & (new.dot(new) < 1e-12)

    v = closest
    core_dist = sqrt_rn(torch.clamp_min(v.dot(v), 0.0))
    dist = core_dist - (sa.margin + sb.margin)
    # v points from the origin toward A - B's closest point
    safe = torch.clamp_min(core_dist, 1e-12)
    n = Vec3(v.x / safe, v.y / safe, v.z / safe)
    # deep overlap (the cores intersect): the initial guess's axis
    return dist, x0.normalize().where(core_dist < 1e-9, n)
