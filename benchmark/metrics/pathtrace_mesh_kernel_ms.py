"""The many-object path-tracing kernel's own time a frame: its total time
in the traced span (torch.profiler) over the span's frames, every launch
counted."""


def read(record):
    span = record.span
    return (span.kernel_ms("pathtrace_mesh_kernel") if span is not None
            else None)
