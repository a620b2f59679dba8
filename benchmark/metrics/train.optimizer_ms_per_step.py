"""Host ms a step of PyTorch's own ``Optimizer.step#Adam.step`` span in the
traced slice: the Adam update."""

from benchmark.metrics.spans import host_ms_per_item


def read(run):
    return host_ms_per_item(run, "Optimizer.step#")
