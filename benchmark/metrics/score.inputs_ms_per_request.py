"""Host ms a request of the program's ``ser#inputs`` span in the traced
slice: ``Predictor.batch_inputs``, the text mean on the host and the copies."""

from benchmark.metrics.spans import host_ms_per_item


def read(run):
    return host_ms_per_item(run, "ser#inputs")
