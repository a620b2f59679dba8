"""Linear and LayerNorm with the JAX package's numerics
(counterpart of ``ser_tpu/ops/layers.py``). Dropout is the identity in eval
and has no module here."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ser_tpu_torch.ops.init import uniform_


class TorchLinear(nn.Module):
    """``nn.Linear`` (weight ``[out, in]``) with torch-default init drawn from
    ``generator``: weight and bias U(+-1/sqrt(in))."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 *, generator: torch.Generator):
        super().__init__()
        bound = in_features ** -0.5
        self.weight = nn.Parameter(uniform_(
            torch.empty(out_features, in_features), bound, generator))
        self.bias = nn.Parameter(uniform_(
            torch.empty(out_features), bound, generator)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


class TorchLayerNorm(nn.Module):
    """``nn.LayerNorm(d, eps=1e-6)`` in the ``(x-mean)*rsqrt(var+eps)`` form
    of ``ser_tpu/ops/layers.py:47-50``."""

    eps = 1e-6

    def __init__(self, d: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(-1, keepdim=True)
        var = (x - mean).square().mean(-1, keepdim=True)
        return (x - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias
