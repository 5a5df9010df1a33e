"""The fused many-object kernel's own time a frame: its total time in the
traced span (torch.profiler) over the span's frames."""


def read(record):
    span = record.span
    return span.kernel_ms("mesh_fused_kernel") if span is not None else None
