"""Device ms of the host-to-device copies (``Memcpy HtoD`` records) a step
in the traced slice."""

from benchmark.metrics.layer import h2d_ms_per_item


def read(run):
    return h2d_ms_per_item(run)
