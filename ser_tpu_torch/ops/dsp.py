"""Standalone DSP ops (counterpart of ``ser_tpu/ops/dsp.py``).

``pre_emphasis`` is the reference's only DSP artifact, its ``PreEmphasis``
conv: y[t] = x[t] - coef * x[t-1], with the reflect pad y[0] = x[0] -
coef * x[1]. The fused front end is ``ser_tpu_torch.ops.mfcc``.
"""

from __future__ import annotations

import torch


def pre_emphasis(x: torch.Tensor, coef: float = 0.97) -> torch.Tensor:
    """x: [B, T] waveforms -> [B, T] pre-emphasized (reflect-padded)."""
    x_prev = torch.cat([x[:, 1:2], x[:, :-1]], dim=1)
    return x - coef * x_prev
