"""Host ms a request of the program's ``ser#forward`` span in the traced
slice: the eval forward, encoders, recurrence, tail and head."""

from benchmark.metrics.spans import host_ms_per_item


def read(run):
    return host_ms_per_item(run, "ser#forward")
