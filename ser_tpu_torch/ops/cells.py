"""Recurrent-cell math (counterpart of ``ser_tpu/ops/cells.py``).

Functions keep the JAX package's layout, ``x @ kernel`` with kernels
``[in, out]``; the modules store weights in the reference's torch layout
``[out, in]`` and callers pass ``weight.T``. Leading batch axes broadcast,
so the recurrence can run both directions at once.
"""

from __future__ import annotations

import torch
from torch import nn

from ser_tpu_torch.ops.init import uniform_
from ser_tpu_torch.ops.layers import TorchLinear


def lsthm_gates(sums: torch.Tensor, c_prev: torch.Tensor):
    """LSTHM gate nonlinearity on the 4H-wide pre-activation in the order
    f, i, o, c-hat (not torch's i, f, g, o). Returns ``(c_t, h_t)``."""
    H = c_prev.shape[-1]
    f_t = torch.sigmoid(sums[..., :H])
    i_t = torch.sigmoid(sums[..., H:2 * H])
    o_t = torch.sigmoid(sums[..., 2 * H:3 * H])
    ch_t = torch.tanh(sums[..., 3 * H:])
    c_t = f_t * c_prev + i_t * ch_t
    return c_t, torch.tanh(c_t) * o_t


def gru_step(x_proj: torch.Tensor, h_prev: torch.Tensor,
             hh_kernel: torch.Tensor, hh_bias: torch.Tensor) -> torch.Tensor:
    """``nn.GRUCell`` step with the x side precomputed (gate order r, z, n;
    ``r`` multiplies ``h @ W_hn + b_hn``).

    x_proj ``[..., 3H]``, h_prev ``[..., H]``, hh_kernel ``[..., H, 3H]``,
    hh_bias broadcastable to ``[..., 3H]``.
    """
    H = h_prev.shape[-1]
    h_proj = torch.matmul(h_prev, hh_kernel) + hh_bias
    r = torch.sigmoid(x_proj[..., :H] + h_proj[..., :H])
    z = torch.sigmoid(x_proj[..., H:2 * H] + h_proj[..., H:2 * H])
    n = torch.tanh(x_proj[..., 2 * H:] + r * h_proj[..., 2 * H:])
    return (1.0 - z) * n + z * h_prev


class LSTHM(nn.Module):
    """The four linears of a speaker-conditioned LSTHM1 cell
    (``sums = W x + U h + V z + S s``); the cell applies them itself."""

    def __init__(self, d_in: int, H: int, Hz: int, Hs: int, *,
                 generator: torch.Generator):
        super().__init__()
        self.W = TorchLinear(d_in, 4 * H, generator=generator)
        self.U = TorchLinear(H, 4 * H, generator=generator)
        self.V = TorchLinear(Hz, 4 * H, generator=generator)
        self.S = TorchLinear(Hs, 4 * H, generator=generator)


class RNNCellWeights(nn.Module):
    """The parameters of ``nn.GRUCell`` (``gates=3``) or ``nn.LSTMCell``
    (``gates=4``), under their names, with their init U(+-1/sqrt(hidden))."""

    def __init__(self, d_in: int, hidden: int, gates: int, *,
                 generator: torch.Generator):
        super().__init__()
        bound = hidden ** -0.5
        shapes = {"weight_ih": (gates * hidden, d_in),
                  "weight_hh": (gates * hidden, hidden),
                  "bias_ih": (gates * hidden,), "bias_hh": (gates * hidden,)}
        for name, shape in shapes.items():
            self.register_parameter(name, nn.Parameter(
                uniform_(torch.empty(shape), bound, generator)))
