"""The share (%) of the traced span's device-idle time in which no program
span below the loop's three stages was open on any host thread: the idle
time the program's spans cannot yet put down to a cause.

A program span is a ``stage:<name>`` host event (the harness's stage
clock marks each span the program opens) other than the loop's
``stage:render+copy``, ``stage:encode+write`` and ``stage:pace``. The idle
time is the span less the union of its device operations
(``device_idle_pct``'s). None without a trace, without idle time, or
where the program opens no such span."""

from __future__ import annotations

LOOP_STAGES = ("stage:render+copy", "stage:encode+write", "stage:pace")


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _overlap(a, b) -> float:
    """The length of the intersection of two sorted disjoint interval
    lists."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def read(record):
    span = record.span
    if span is None:
        return None
    spans = _union((max(s, span.start_us), min(e, span.end_us))
                   for name, s, e in span.host
                   if name.startswith("stage:") and name not in LOOP_STAGES
                   and e > span.start_us and s < span.end_us)
    if not spans:
        return None
    idle, t = [], span.start_us
    for s, e in span.busy() + [(span.end_us, span.end_us)]:
        if s > t:
            idle.append([t, s])
        t = max(t, e)
    idle_us = sum(e - s for s, e in idle)
    if idle_us <= 0:
        return None
    return 100.0 * (idle_us - _overlap(idle, spans)) / idle_us
