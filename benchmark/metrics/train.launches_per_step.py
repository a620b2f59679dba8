"""CUDA kernels a step: the kernels the device ran in the traced slice,
over the steps in it."""

from benchmark.metrics.layer import launches_per_item


def read(run):
    return launches_per_item(run)
