"""The share of the traced span in which no device operation (kernel,
copy or fill) ran: the span less the union of the device events'
intervals, over the span."""


def read(record):
    span = record.span
    if span is None or span.seconds <= 0:
        return None
    return 100.0 * (1.0 - span.busy_seconds() / span.seconds)
