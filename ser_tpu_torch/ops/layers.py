"""Linear, LayerNorm and inverted dropout with the JAX package's numerics
(counterpart of ``ser_tpu/ops/layers.py``).

Dropout draws its keep mask from an explicit ``torch.Generator`` that the
caller owns (on the card a CUDA generator), never from the global one, so a
train step is reproducible from the trainer's seed. ``Dropout`` holds no
parameters: the modules that use it keep the reference's state-dict keys."""

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


def dropout(x: torch.Tensor, p: float, generator: torch.Generator | None
            ) -> torch.Tensor:
    """Inverted dropout, ``where(keep, x / (1 - p), 0)`` with ``keep`` drawn
    Bernoulli(1 - p) from ``generator`` (on ``x``'s device). Rate 0 or no
    generator (eval) is the identity."""
    if p == 0.0 or generator is None:
        return x
    keep = 1.0 - p
    mask = torch.empty(x.shape, device=x.device).bernoulli_(
        keep, generator=generator).bool()
    return torch.where(mask, x / keep, 0.0)


def train_generator(model: nn.Module, generator: torch.Generator | None
                    ) -> torch.Generator | None:
    """The generator every dropout of ``model`` draws from: in train mode
    ``generator``, which must be given there and lie on the model's device;
    None in eval."""
    if model.training and generator is None:
        raise RuntimeError(f"{type(model).__name__} in train mode needs a "
                           "torch.Generator for its dropouts; call .eval() to serve")
    return generator if model.training else None


class Dropout(nn.Module):
    """``nn.Dropout(p)`` with an explicit generator: in train mode
    ``forward(x, generator)`` drops from ``generator``; in eval mode, or
    given no generator, it is the identity. The models refuse train mode
    without a generator (``train_generator``), so a train step always drops."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        return dropout(x, self.p, generator) if self.training else x

    def extra_repr(self) -> str:
        return f"p={self.p}"
