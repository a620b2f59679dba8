"""CUDA kernels a request: the kernels the device ran in the traced slice,
over the requests in it."""

from benchmark.metrics.layer import launches_per_item


def read(run):
    return launches_per_item(run)
