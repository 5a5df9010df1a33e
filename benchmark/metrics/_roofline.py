"""The card's peaks and the kernels' work counts for the rooflines.

A kernel's roofline share is the least time the card could take for the
work, the larger of its FP32 operations over 67 TFLOP/s and its bytes
over 3.35 TB/s (NVIDIA H100 SXM data sheet, at 700 W), over the
kernel's own time a frame from the profiler, every launch counted. The operations are
counted from the work the benchmark's reference does for the same frames
(its traces; the path tracer's nearest-hit traces, hits and unblocked
shadow rays) times the operations of the kernels' inner tests, counted
from the CUDA sources; the counts leave out comparisons and conversions,
so the bound is a floor.
"""

from __future__ import annotations

PEAK_FP32 = 67e12  # operations/s
PEAK_BYTES = 3.35e12  # bytes/s

# render.cu blocked(): one sphere, the ground plane
DEMO_SHADOW_SPHERE_OPS = 19
DEMO_SHADOW_PLANE_OPS = 14
# pathtrace.cu and the common.cuh functions it calls (cosf, sinf: 1 each)
PT_TRACE_OPS = 20  # trace() setup (a, 1/2a) 6, the plane 14
PT_TRACE_SPHERE_OPS = 20  # trace(), one sphere, no root
PT_HIT_OPS = 35  # finish_hit(), plane form
PT_MISS_OPS = 10  # miss_hit(): one normalize3
PT_SHADOW_SPHERE_OPS = 21  # blocked() with tmax, one sphere
PT_SHADOW_PLANE_OPS = 14  # blocked(), the plane; a blocked ray's floor
PT_NEE_OPS = 61  # a light sample, its direction, falloff and radiance
PT_CONTINUE_OPS = 23  # the branch draw, a mirror direction, normalize3
PT_PATH_OPS = 129  # the jittered primary ray (44), the sky and the sum (85)


def bound_ms(ops: float, nbytes: float) -> float:
    """The least time the card could take, in ms."""
    return max(1e3 * ops / PEAK_FP32, 1e3 * nbytes / PEAK_BYTES)


def demo_bound_ms(traces: int, n_px: int, n_spheres: int = 6,
                  n_dlights: int = 1, n_plights: int = 1) -> float:
    """The render kernel's bound for a frame: every trace costs at least a
    shadow trace (the cheaper kind) against every sphere and the plane;
    it reads the packed scene and writes 16 bytes a pixel."""
    return bound_ms(
        traces * (n_spheres * DEMO_SHADOW_SPHERE_OPS + DEMO_SHADOW_PLANE_OPS),
        4 * (17 + 9 * n_spheres + 16 + 6 * n_dlights + 7 * n_plights)
        + 16 * n_px)


def pathtrace_ops(work, n_spheres: int, n_lights: int, n_paths: int
                  ) -> float:
    """FP32 operations of a path-traced frame from its work (nearest-hit
    traces, hits, unblocked shadow rays): every trace tests every sphere
    and the plane, a hit is fixed up and continued, a miss normalized;
    every hit samples each light; an unblocked shadow ray tests every
    sphere and the plane, a blocked one at least the plane; every path
    makes its primary ray and folds the sky."""
    nearest, hits, unblocked = (int(v) for v in work)
    shadow = hits * n_lights
    return float(
        nearest * (PT_TRACE_OPS + n_spheres * PT_TRACE_SPHERE_OPS)
        + hits * (PT_HIT_OPS + PT_CONTINUE_OPS + n_lights * PT_NEE_OPS)
        + (nearest - hits) * PT_MISS_OPS
        + unblocked * (n_spheres * PT_SHADOW_SPHERE_OPS + PT_SHADOW_PLANE_OPS)
        + (shadow - unblocked) * PT_SHADOW_PLANE_OPS
        + n_paths * PT_PATH_OPS)


def pathtrace_bound_ms(work, n_spheres: int, n_lights: int, n_px: int,
                       n_paths: int) -> float:
    """The path tracer's bound for a frame: its operations, and the packed
    scene and lights read, 20 bytes a pixel written (the color and two
    counts)."""
    return bound_ms(pathtrace_ops(work, n_spheres, n_lights, n_paths),
                    4 * (17 + 9 * n_spheres + 16 + 8 * n_lights) + 20 * n_px)


def share_pct(bound: float, kernel_ms: float | None) -> float | None:
    """100 x a frame's bound / the kernel's ms a frame; None without the
    kernel."""
    if kernel_ms is None or bound <= 0:
        return None
    return 100.0 * bound / kernel_ms
