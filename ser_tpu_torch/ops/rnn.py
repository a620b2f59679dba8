"""Full-sequence LSTM and GRU (counterpart of ``ser_tpu/ops/rnn.py``).

The JAX package writes ``nn.LSTM(input, hidden, bidirectional=True)`` as two
scans over the padded sequence, the backward one over the whole padded
sequence reversed, padding included, as torch's LSTM runs on unpacked padded
input, and ``nn.GRU(input, hidden)`` as one scan of ``gru_step`` (gate order
r, z, n). Here they are those modules themselves (cuDNN's LSTM and GRU on
the card), with the reference's parameter names and their init drawn from an
explicit generator.
"""

from __future__ import annotations

import torch
from torch import nn

from ser_tpu_torch.ops.init import uniform_


def _fill(module: nn.RNNBase, hidden: int, generator: torch.Generator) -> None:
    """Every weight and bias of a module built on the meta device
    U(+-1/sqrt(hidden)) from ``generator``: torch's own init draws nothing
    from the global generator."""
    module.to_empty(device="cpu")
    for p in module.parameters():
        uniform_(p, hidden ** -0.5, generator)


class TorchBiLSTM(nn.LSTM):
    """``nn.LSTM(d_in, hidden, bidirectional=True)`` on time-major ``[L, B,
    d_in]``, returning only the outputs ``[L, B, 2 * hidden]`` (forward |
    backward). Every weight and bias is U(+-1/sqrt(hidden)) from
    ``generator``: the module is built on the meta device, so torch's own
    init draws nothing from the global generator."""

    def __init__(self, d_in: int, hidden: int, *, generator: torch.Generator):
        super().__init__(d_in, hidden, bidirectional=True, device="meta")
        _fill(self, hidden, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # noqa: D102
        return super().forward(x)[0]


class TorchGRU(nn.GRU):
    """``nn.GRU(d_in, hidden)``, one direction, on time-major ``[L, B,
    d_in]``: ``forward(x, h0=None)`` returns ``(outputs [L, B, hidden],
    h_last [B, hidden])``, as the JAX module does. Keys ``weight_ih_l0``,
    ``weight_hh_l0``, ``bias_ih_l0``, ``bias_hh_l0``; init as
    ``TorchBiLSTM``'s."""

    def __init__(self, d_in: int, hidden: int, *, generator: torch.Generator):
        super().__init__(d_in, hidden, device="meta")
        _fill(self, hidden, generator)

    def forward(self, x: torch.Tensor, h0: torch.Tensor | None = None):  # noqa: D102
        out, h_n = super().forward(x, None if h0 is None else h0[None])
        return out, h_n[0]
