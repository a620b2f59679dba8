"""MARN1_onlysp, eval path (counterpart of ``ser_tpu/models/marn_onlysp.py``).

A bidirectional dialogue recurrence over per-utterance text and audio
features: a GRU speaker memory, speaker-conditioned LSTHM1 cells per
modality and a per-step rank-1 fusion state z, then sequence cross attention
with learnable scalar fusion weights (w, v, v1, v2) and a two-layer MLP head
that emits per-utterance log-probabilities.

Parameter names and layouts are the reference's torch ones, so
``state_dict()`` keys equal those of the JAX package's
``export_state_dict(params, "MARN1_onlysp", prefix="")``. Parameters the
reference declares and never uses are kept for parameter-count parity.
Both recurrence directions run as one call of
``ops.kernels.lsthm.lsthm_onlysp_recurrence_bidir``: the CUDA kernel on the
card, its plain version on the CPU.
"""

from __future__ import annotations

import torch
from torch import nn

from ser_tpu_torch.ops.attention import (CrossAttentionReSeq,
                                         CrossAttentionSeq, Rank1Weights)
from ser_tpu_torch.ops.cells import LSTHM, RNNCellWeights
from ser_tpu_torch.ops.encoder import EncoderLayer
from ser_tpu_torch.ops.kernels.lsthm import lsthm_onlysp_recurrence_bidir
from ser_tpu_torch.ops.layers import TorchLinear
from ser_tpu_torch.ops.masking import reverse_seq


class MARNCellOnlySP(nn.Module):
    """The parameters of one recurrence direction, and the step-independent
    work around the recurrence: the hoisted x-side projections and the fused
    state weights."""

    def __init__(self, *, generator: torch.Generator):
        super().__init__()
        g, dh, d_in = generator, 128, 100
        self.lsthm_l = LSTHM(d_in, dh, dh, dh, generator=g)
        self.lsthm_a = LSTHM(d_in, dh, dh, dh, generator=g)
        self.gru_s = RNNCellWeights(2 * d_in, dh, 3, generator=g)
        # Declared and never used by the reference (lsthm_onlysp.py:147-155).
        self.lstm_q0 = RNNCellWeights(dh, dh, 4, generator=g)
        self.lstm_q1 = RNNCellWeights(dh, dh, 4, generator=g)
        self.lstm_s = RNNCellWeights(dh, dh, 4, generator=g)
        self.crossatt_l2a = Rank1Weights(dh)  # Wv unused
        self.crossatt_a2l = Rank1Weights(dh)  # unused

    def gather(self, x_l, x_a, qmask):
        """``(seqs, consts)`` of the recurrence for this direction.

        x_l, x_a ``[L, B, 100]``, qmask ``[L, B, 2]``. The state weights are
        fused as ``K = [U; V; S]`` (rows h, z, s; ``[3H, 4H]``) with
        ``b = bU + bV + bS``.
        """
        l, a, gru = self.lsthm_l, self.lsthm_a, self.gru_s
        xl_proj = torch.matmul(x_l, l.W.weight.T) + l.W.bias
        xa_proj = torch.matmul(x_a, a.W.weight.T) + a.W.bias
        gru_x = torch.matmul(torch.cat([x_l, x_a], -1), gru.weight_ih.T) \
            + gru.bias_ih
        K_l = torch.cat([l.U.weight.T, l.V.weight.T, l.S.weight.T], 0)
        b_l = l.U.bias + l.V.bias + l.S.bias
        K_a = torch.cat([a.U.weight.T, a.V.weight.T, a.S.weight.T], 0)
        b_a = a.U.bias + a.V.bias + a.S.bias
        seqs = (xl_proj, xa_proj, gru_x, qmask)
        consts = (K_l, b_l, K_a, b_a, gru.weight_hh.T, gru.bias_hh,
                  self.crossatt_l2a.Wq[0], self.crossatt_l2a.Wk[0])
        return seqs, consts


class MARN1OnlySP(nn.Module):
    """MARN1_onlysp. Input x is time-major ``[L, B, 1124]`` = RoBERTa-1024
    text | audio-100, qmask ``[L, B, 2]``, umask ``[B, L]``. Returns
    ``(log_probs [B*L, n_classes], x_l, x_a)`` with x_l, x_a the
    post-encoder time-major features."""

    d_r = 1024
    d_m = 100

    def __init__(self, n_classes: int = 6, *, generator: torch.Generator):
        super().__init__()
        g = generator
        self.n_classes = n_classes
        self.linear_in = TorchLinear(self.d_r, self.d_m, generator=g)
        self.encoder_l = EncoderLayer(100, 40, 8, 40, 40, generator=g)
        self.encoder_a = EncoderLayer(100, 40, 8, 40, 40, generator=g)
        self.marn_cell_f = MARNCellOnlySP(generator=g)
        self.marn_cell_b = MARNCellOnlySP(generator=g)
        for name in ("w", "v", "v1", "v2"):
            self.register_parameter(name, nn.Parameter(torch.ones(1)))
        self.crossatt_l2a = CrossAttentionSeq()
        self.crossatt_a2l = CrossAttentionSeq()
        self.crossatt_l2a_1 = CrossAttentionReSeq()
        self.crossatt_a2l_1 = CrossAttentionReSeq()
        d_feat = 4 * 128 * 2 + 2 * 128
        # index 2 is the reference's Dropout(0.5), the identity in eval
        self.nn_out = nn.Sequential(
            TorchLinear(d_feat, 32, generator=g), nn.ReLU(), nn.Identity(),
            TorchLinear(32, n_classes, generator=g))
        self.linear = TorchLinear(d_feat, 32, generator=g)  # unused (ref :229)

    def recurrence_inputs(self, x, qmask, umask):
        """Everything before the recurrence: ``(seqs, consts, x_l, x_a)``
        with seqs and consts in the kernel's contract, both directions
        stacked on axis 1 and 0, and x_l, x_a the encoded ``[L, B, 100]``."""
        x_l = self.linear_in(x[:, :, :self.d_r].transpose(0, 1))  # [B, L, 100]
        x_a = x[:, :, self.d_r:self.d_r + self.d_m].transpose(0, 1)
        # The reference applies the same encoder layer twice (shared weights).
        x_l = self.encoder_l(self.encoder_l(x_l)).transpose(0, 1)  # [L, B, 100]
        x_a = self.encoder_a(self.encoder_a(x_a)).transpose(0, 1)

        seqs_f, consts_f = self.marn_cell_f.gather(x_l, x_a, qmask)
        seqs_b, consts_b = self.marn_cell_b.gather(
            reverse_seq(x_l, umask), reverse_seq(x_a, umask),
            reverse_seq(qmask, umask))
        seqs = tuple(torch.stack([f, b], 1).contiguous()
                     for f, b in zip(seqs_f, seqs_b))
        consts = tuple(torch.stack([f, b]).contiguous()
                       for f, b in zip(consts_f, consts_b))
        return seqs, consts, x_l, x_a

    def forward(self, x, qmask, umask):
        if self.training:
            raise RuntimeError("MARN1OnlySP is ported for eval only; call .eval()")
        seqs, consts, x_l, x_a = self.recurrence_inputs(x, qmask, umask)
        ys = lsthm_onlysp_recurrence_bidir(seqs, consts)  # [L, 2, B, 512]
        h = torch.cat([ys[:, 0], reverse_seq(ys[:, 1], umask)], -1)

        w, v = self.w * x_l, self.v * x_a
        attn1 = self.crossatt_l2a(w, v)
        attn2 = self.crossatt_a2l(v, w)
        attn1 = self.crossatt_l2a_1(v, self.v1 * attn1)
        attn2 = self.crossatt_a2l_1(w, self.v2 * attn2)

        out = self.nn_out(torch.cat([h, attn1, attn2], -1))  # [L, B, C]
        logp = torch.log_softmax(out, dim=2)
        logp = logp.transpose(0, 1).reshape(-1, self.n_classes)  # [B*L, C]
        return logp, x_l, x_a
