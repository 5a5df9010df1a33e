"""The many-object path tracer's roofline bound: a floor that no walk of
the scene can beat, from the work the reference counts for a frame
(nearest-hit traces, hits, unblocked shadow rays).

Each ray, nearest-hit or shadow, is charged its set-up and ONE narrow
test, the cheaper of a sphere's and a triangle's: any walk that finds the
nearest object, or a blocker, tests at least that object. No further
per-object test and no box test is counted, so the share stays at most
100% whatever walk implements it. Each hit adds the path tracer's fix-up,
continuation and light samples, each miss its normalize, and each path
its primary ray, sky and sum (``_roofline``'s PT_* counts of
csrc/pathtrace.cuh); the bytes are the kernel tables read once and 20
bytes a pixel written. Operations counted from csrc/mesh.cu, comparisons
and conversions left out.
"""

from __future__ import annotations

from benchmark.metrics._roofline import (PT_CONTINUE_OPS, PT_HIT_OPS,
                                         PT_MISS_OPS, PT_NEE_OPS,
                                         PT_PATH_OPS, bound_ms)

# make_ray(): a (5), 0.5 / a (1), o.d (5), o.o (5), 4a (1); cinv(): three
# divisions
RAY_OPS = 20
# MeshTracer::blocked()'s set-up: |p|^2 (5), p.l (5), three divisions
SHADOW_RAY_OPS = 13
# sphere_hit() without its root, and blocked()'s sphere test without its
# tmax cut: two dot_zyx (3 each), b (2), c (3), disc (2); tri_t() is 32
NARROW_OPS = 13
# the kernel tables: a sphere's centre and ccr2, material, specularity,
# id; a triangle's three float4 rows, normal, material, specularity, id
SPHERE_BYTES = 16 + 16 + 4 + 4
TRIANGLE_BYTES = 48 + 16 + 16 + 4 + 4
CAM_FLOATS, AREA_LIGHT_FLOATS = 17, 8


def ops(work, n_lights: int, n_paths: int) -> float:
    """FP32 operations of a path-traced frame of the many-object scene
    from its work (nearest-hit traces, hits, unblocked shadow rays):
    every hit casts one shadow ray a light."""
    nearest, hits, _unblocked = (int(v) for v in work)
    return float(
        nearest * (RAY_OPS + NARROW_OPS)
        + hits * (PT_HIT_OPS + PT_CONTINUE_OPS + n_lights * PT_NEE_OPS)
        + (nearest - hits) * PT_MISS_OPS
        + hits * n_lights * (SHADOW_RAY_OPS + NARROW_OPS)
        + n_paths * PT_PATH_OPS)


def frame_bound_ms(work, n_spheres: int, n_triangles: int, n_lights: int,
                   n_px: int, n_paths: int) -> float:
    """The bound of one frame, in ms: its operations, or the tables, the
    camera and lights read and 20 bytes a pixel written."""
    nbytes = (n_spheres * SPHERE_BYTES + n_triangles * TRIANGLE_BYTES
              + 4 * (CAM_FLOATS + AREA_LIGHT_FLOATS * n_lights)
              + 20 * n_px)
    return bound_ms(ops(work, n_lights, n_paths), nbytes)
