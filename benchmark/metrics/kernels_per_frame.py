"""CUDA kernels (no copies, no fills) that start in the traced span, over
its frames (torch.profiler's device events)."""


def read(record):
    span = record.span
    if span is None:
        return None
    return len(span.kernels()) / span.frames
