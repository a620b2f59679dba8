"""The card's published peaks, and the least time of a piece of work.

NVIDIA H100 SXM5 (``NVIDIA H100 80GB HBM3``) at its 700 W limit, NVIDIA's
data sheet, dense rates: FP32 66.9 TFLOP/s outside the tensor cores (the
program runs f32 with TF32 off), HBM3 3.35 TB/s.
"""

from __future__ import annotations

F32_FLOPS = 66.9e12
HBM_BYTES = 3.35e12


def least_seconds(flops: float, nbytes: float) -> tuple[float, str]:
    """The larger of the operations at the FP32 rate and the bytes at the
    HBM rate, and which of the two it is."""
    t_ops, t_bytes = flops / F32_FLOPS, nbytes / HBM_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
