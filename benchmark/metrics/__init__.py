"""Per-layer metrics, one reader a file: ``metrics/<metric>.py`` defines
``read(record) -> float | None`` (``trace.Record``). A reader that finds
nothing to read returns None, and the metric is left out of the line.
Files whose names start with ``_`` are shared helpers, not metrics."""
