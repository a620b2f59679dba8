"""PyTorch-default initialisation from an explicit generator.

Counterpart of ``ser_tpu/ops/init.py``: ``nn.Linear`` weights and biases are
U(+-1/sqrt(fan_in)), RNN-cell weights and biases U(+-1/sqrt(hidden)),
LayerNorm ones and zeros, and the attention and fusion vectors ones. Drawing
from a caller's ``torch.Generator`` makes full-width weights reproducible
from a seed, with no files.
"""

from __future__ import annotations

import torch


def uniform_(tensor: torch.Tensor, bound: float,
             generator: torch.Generator) -> torch.Tensor:
    """Fill ``tensor`` in place with U(-bound, bound) from ``generator``."""
    with torch.no_grad():
        draw = torch.rand(tensor.shape, generator=generator,
                          dtype=tensor.dtype, device=generator.device)
        return tensor.copy_(draw * (2 * bound) - bound)


def generator(seed: int) -> torch.Generator:
    """A CPU generator seeded with ``seed`` (weights are made on the CPU and
    then moved, so the CPU and the card get the same values)."""
    return torch.Generator().manual_seed(int(seed))
