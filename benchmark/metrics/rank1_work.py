"""The least work of the rank-1 cross attention, the function that
``csrc/rank1_attention.cu`` computes, at [2, B, D] (both directions, D =
128), whatever implements it.

Per (direction, row, i, k) pair, as ``chip_smoke.py::rank1_bound`` counts
them: the forward one exp and 4 flops (the logit product, the shift, the
two sums), the backward one exp again (the function keeps no [B, D, D]
state between the two) and 12 flops; each exp counted as one operation at
the FP32 rate. Bytes: x1, x2, wq, wk in and z out, and in the backward
also g in and dx1, dx2, dwq, dwk out, each element read or written once.
"""

from __future__ import annotations

from benchmark.peaks import least_seconds

D = 128


def least_seconds_of(B: int, backward: bool, itemsize: int = 4) -> float:
    pairs, row, vec = 2 * B * D * D, 2 * B * D * itemsize, 2 * D * itemsize
    if backward:
        return least_seconds(13 * pairs, 5 * row + 4 * vec)[0]
    return least_seconds(5 * pairs, 3 * row + 2 * vec)[0]


def roofline_pct(run, kernels, train: bool):
    """The least time of every rank-1 evaluation in the slice over the
    device time of ``kernels``, in percent; None where the model has no
    rank-1 attention or the slice ran none of ``kernels``."""
    calls = getattr(run.reference, "rank1_calls", None)
    spent = run.trace.device_seconds(kernels) if run.trace else 0.0
    if calls is None or spent <= 0:
        return None
    least = 0.0
    for L, B in run.slice_shapes:
        n_fwd, n_bwd = calls(L, train)
        least += n_fwd * least_seconds_of(B, False) + n_bwd * least_seconds_of(B, True)
    return 100.0 * least / spent
