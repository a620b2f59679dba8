"""Host ms a step of the program's ``ser#backward`` span in the traced slice:
autograd's backward, which the main thread waits in."""

from benchmark.metrics.spans import host_ms_per_item


def read(run):
    return host_ms_per_item(run, "ser#backward")
