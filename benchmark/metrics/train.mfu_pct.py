"""The whole step's share of the card's FP32 peak: the matrix-product
FLOPs of the benchmark's reference (``matmul_flops`` of its module, at each
step's [L, B]) over the untraced part of the window."""

from benchmark.metrics.layer import mfu_pct


def read(run):
    return mfu_pct(run, train=True)
