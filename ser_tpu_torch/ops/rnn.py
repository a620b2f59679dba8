"""Full-sequence LSTM (counterpart of ``ser_tpu/ops/rnn.py``).

The JAX package writes ``nn.LSTM(input, hidden, bidirectional=True)`` as two
scans over the padded sequence, the backward one over the whole padded
sequence reversed, padding included, as torch's LSTM runs on unpacked padded
input. Here it is that module itself (cuDNN's LSTM on the card), with the
reference's parameter names and its init drawn from an explicit generator.
"""

from __future__ import annotations

import torch
from torch import nn

from ser_tpu_torch.ops.init import uniform_


class TorchBiLSTM(nn.LSTM):
    """``nn.LSTM(d_in, hidden, bidirectional=True)`` on time-major ``[L, B,
    d_in]``, returning only the outputs ``[L, B, 2 * hidden]`` (forward |
    backward). Every weight and bias is U(+-1/sqrt(hidden)) from
    ``generator``: the module is built on the meta device, so torch's own
    init draws nothing from the global generator."""

    def __init__(self, d_in: int, hidden: int, *, generator: torch.Generator):
        super().__init__(d_in, hidden, bidirectional=True, device="meta")
        self.to_empty(device="cpu")
        for p in self.parameters():
            uniform_(p, hidden ** -0.5, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # noqa: D102
        return super().forward(x)[0]
