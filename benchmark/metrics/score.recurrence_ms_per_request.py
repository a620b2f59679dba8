"""Host ms a request of the program's ``ser#recurrence`` span in the traced
slice: the bidirectional eval loop (``fused_directions``)."""

from benchmark.metrics.spans import host_ms_per_item


def read(run):
    return host_ms_per_item(run, "ser#recurrence")
