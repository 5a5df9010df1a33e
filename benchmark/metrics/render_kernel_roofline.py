"""The render kernel's share of its roofline: the bound of the mean
frame of the span, from the traces the reference counts for those frames
(``_roofline.demo_bound_ms``), over the kernel's time a frame (its total
in the span over the span's frames): the span's summed bound over the
kernel's summed time."""

from benchmark.metrics import _roofline


def read(record):
    span = record.span
    if span is None:
        return None
    k = span.kernel_ms("render_kernel")
    work = record.profiled_work()
    if k is None or not work:
        return None
    c = record.config
    n_px = c["width"] * c["height"]
    bound = sum(_roofline.demo_bound_ms(t, n_px) for t in work) / len(work)
    return _roofline.share_pct(bound, k)
