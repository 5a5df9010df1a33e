"""The many-object path-tracing kernel's share of its roofline: the bound
of the mean frame of the span, from the work the reference counts for
those whole frames (``_roofline_mesh_pt.frame_bound_ms``, one area
light), over the kernel's time a frame (its total in the span over the
span's frames): the span's summed bound over the kernel's summed time."""

from benchmark.metrics import _roofline, _roofline_mesh_pt


def read(record):
    span = record.span
    if span is None:
        return None
    k = span.kernel_ms("pathtrace_mesh_kernel")
    if k is None:
        return None
    work = record.profiled_work()
    if not work:
        return None
    c = record.config
    n_px = c["width"] * c["height"]
    bound = sum(_roofline_mesh_pt.frame_bound_ms(
        w, c["n_spheres"], c["floor_triangles"], 1, n_px, n_px * c["spp"])
        for w in work) / len(work)
    return _roofline.share_pct(bound, k)
