"""Per-layer metric readers, one file a metric, named as the metric is in
``BENCHMARK.json``. Each has ``read(run) -> float | None``: ``run`` is a
``benchmark.cell.Readings`` (the traced slice, the shapes of its steps or
requests, the untraced part of the window, the reference module). A reader
that finds nothing to read returns None, and the metric is left out of the
result line."""
