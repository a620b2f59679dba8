"""The BiLSTM baseline (counterpart of ``ser_tpu/models/bilstm.py``; ref
``model/lstm.py:40-94``).

One encoder a modality (d_inner 50) on x_l = x[..., :100] and x_a =
x[..., 100:200] (both text dims under the reference trainer's input), a
bidirectional LSTM each (text 128, audio 16), then ``lstm_head``: the two
outputs concatenated batch-major and an MLP head ending in softmax. The
model emits probabilities, not log-probabilities: the masked loss applies
log-softmax on top, as the JAX trainer does. It has 6 outputs whatever the
class count, as the JAX registry builds it.
"""

from __future__ import annotations

import torch
from torch import nn

from ser_tpu_torch.ops.encoder import EncoderLayer
from ser_tpu_torch.ops.layers import Dropout, TorchLinear, train_generator
from ser_tpu_torch.ops.rnn import TorchBiLSTM

D_M = 100  # the modality width each LSTM reads
DH_L, DH_A = 128, 16  # the LSTMs' hidden widths


def probs_head(d_in: int, n_classes: int, generator: torch.Generator) -> nn.Sequential:
    """``Linear -> ReLU -> Dropout(0) -> Linear`` (the reference's ``nn_out``;
    index 2 is its ``Dropout(0.0)``); the caller applies the softmax."""
    return nn.Sequential(TorchLinear(d_in, 32, generator=generator), nn.ReLU(),
                         Dropout(0.0), TorchLinear(32, n_classes, generator=generator))


def apply_head(nn_out: nn.Sequential, x: torch.Tensor, generator) -> torch.Tensor:
    """softmax of ``nn_out`` over the last axis."""
    lin, relu, drop, out = nn_out
    return torch.softmax(out(drop(relu(lin(x)), generator)), -1)


def lstm_head(model: nn.Module, x_l: torch.Tensor, x_a: torch.Tensor, generator
              ) -> torch.Tensor:
    """BiLSTM's and MARN's path from the modalities to the probabilities:
    ``model.lstm_l`` on x_l and ``model.lstm_a`` on x_a (time-major ``[L, B,
    100]``), the outputs concatenated and taken batch-major, ``[B*L, 288]``,
    then ``model.nn_out`` and softmax: ``[B*L, C]``."""
    y = torch.cat([model.lstm_l(x_l), model.lstm_a(x_a)], 2).transpose(0, 1)
    return apply_head(model.nn_out, y.reshape(-1, y.shape[-1]), generator)


class BiLSTM(nn.Module):
    """BiLSTM. Input x time-major ``[L, B, 1024 + d_audio]``; qmask and
    umask are accepted and not read. Returns ``(probs [B*L, n_classes], x_l,
    x_a)`` with x_l, x_a the encoded time-major features. In train mode the
    encoders' dropouts draw from ``generator``, which must be given."""

    def __init__(self, n_classes: int = 6, *, generator: torch.Generator,
                 encoder_attention: str = "mha"):
        super().__init__()
        g = generator
        self.encoder_l = EncoderLayer(D_M, 50, 8, 40, 40, generator=g, attention=encoder_attention)
        self.encoder_a = EncoderLayer(D_M, 50, 8, 40, 40, generator=g, attention=encoder_attention)
        self.lstm_l = TorchBiLSTM(D_M, DH_L, generator=g)
        self.lstm_a = TorchBiLSTM(D_M, DH_A, generator=g)
        self.nn_out = probs_head(2 * (DH_L + DH_A), n_classes, g)

    def forward(self, x, qmask=None, umask=None, generator: torch.Generator | None = None):
        g = train_generator(self, generator)
        enc = lambda e, xx: e(xx.transpose(0, 1), g).transpose(0, 1)  # noqa: E731
        x_l = enc(self.encoder_l, x[:, :, :D_M])
        x_a = enc(self.encoder_a, x[:, :, D_M:2 * D_M])
        return lstm_head(self, x_l, x_a, g), x_l, x_a
