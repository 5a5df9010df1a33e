"""``frame_ms_p95`` of a batched cell, read per layer: the 95th
percentile of the intervals between the window's writes' ends, as the
harness computes the end-to-end metric. In the batched loop a batch's
eight writes come together and its last waits on the next batch, so the
percentile falls among those waits and moves with the host by more than
the largest bound allows; the cell holds ``fps`` and ``latency_ms_p95``
end to end instead."""


def read(record):
    return record.end_to_end.get("frame_ms_p95")
