"""MARN1_onlysp, eval and train forward (counterpart of
``ser_tpu/models/marn_onlysp.py``).

A bidirectional dialogue recurrence over per-utterance text and audio
features: a GRU speaker memory, speaker-conditioned LSTHM1 cells per
modality and a per-step rank-1 fusion state z, then sequence cross attention
with learnable scalar fusion weights (w, v, v1, v2) and a two-layer MLP head
that emits per-utterance log-probabilities.

Parameter names and layouts are the reference's torch ones, so
``state_dict()`` keys equal those of the JAX package's
``export_state_dict(params, "MARN1_onlysp", prefix="")``. Parameters the
reference declares and never uses are kept for parameter-count parity; the
forward never touches them, so their ``.grad`` stays None and Adam skips
them. The dropout modules hold no parameters.

In eval mode both recurrence directions run as one call of
``ops.kernels.lsthm.lsthm_onlysp_recurrence_bidir``: the CUDA kernel on the
card, its plain version on the CPU. In train mode (``model.train()``, and a
``torch.Generator`` on the model's device passed to ``forward``) the
recurrence is a Python loop over T of the ported ops, both directions
stacked on a leading axis (``_train_step_dir`` under the JAX package's
``_fused_directions``), with dropout 0.5 on h_s, h_l and h_a and the rank-1
attention's train form bound once a call by ``ops.kernels.rank1.bind``: the
CUDA kernel on the card, with its own backward; the plain version on the CPU.
"""

from __future__ import annotations

import torch
from torch import nn

from ser_tpu_torch.ops.attention import (CrossAttentionReSeq,
                                         CrossAttentionSeq, Rank1Weights,
                                         attention_tail)
from ser_tpu_torch.ops.cells import LSTHM, RNNCellWeights, gru_step, lsthm_gates
from ser_tpu_torch.ops.encoder import EncoderLayer
from ser_tpu_torch.ops.kernels.lsthm import lsthm_onlysp_recurrence_bidir
from ser_tpu_torch.ops.kernels.rank1 import bind as rank1_bind
from ser_tpu_torch.ops.layers import Dropout, TorchLinear, dropout, train_generator
from ser_tpu_torch.ops.masking import reverse_seq, scatter_parties, select_parties
from ser_tpu_torch.utils import profiling


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

        x_l, x_a ``[L, B, 100]``, qmask ``[L, B, P]``. The state weights are
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


def train_recurrence(seqs, consts, generator: torch.Generator,
                     dropout_rate: float = 0.5, attn_dropout: float = 0.2
                     ) -> torch.Tensor:
    """Both directions of the train-mode recurrence, differentiable.

    ``seqs`` and ``consts`` are the eval kernel's contract (``[T, 2, B, .]``
    and ``[2, .]``); returns ``[T, 2, B, 4H]`` = ``[h_l | h_a | z | h_s]``.
    A step draws three dropout masks from ``generator`` and the rank-1
    attention's mask from one int32 seed per call, also drawn from it on its
    device, so drawing costs the host no sync."""
    with profiling.annotate("ser#recurrence"):
        xl_proj, xa_proj, gru_x, qmask = seqs
        K_l, b_l, K_a, b_a, gWhh, gbhh, wq, wk = consts
        b_l, b_a, gbhh = b_l[:, None], b_a[:, None], gbhh[:, None]
        T, _, B = xl_proj.shape[:3]
        H = K_l.shape[-1] // 4
        seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                             device=generator.device, dtype=torch.int32)
        zeros = lambda *s: xl_proj.new_zeros(s)
        h_l, c_l, h_a, c_a, z = (zeros(2, B, H) for _ in range(5))
        q = zeros(2, B, qmask.shape[-1], gWhh.shape[-2])
        drop = lambda x: dropout(x, dropout_rate, generator)
        attend = rank1_bind(wq, wk, seed, attn_dropout)  # wq, wk, seed, p checked once
        ys = []
        for t in range(T):
            qm = qmask[t]
            h_s = drop(gru_step(gru_x[t], select_parties(q, qm), gWhh, gbhh))
            q = scatter_parties(q, qm, h_s)
            c_l, h_l = lsthm_gates(
                xl_proj[t] + torch.matmul(torch.cat([h_l, z, h_s], -1), K_l) + b_l, c_l)
            h_l = drop(h_l)
            c_a, h_a = lsthm_gates(
                xa_proj[t] + torch.matmul(torch.cat([h_a, z, h_s], -1), K_a) + b_a, c_a)
            h_a = drop(h_a)
            z = attend(c_l, c_a, t)
            ys.append(torch.cat([h_l, h_a, z, h_s], -1))
        return torch.stack(ys)


class MARN1OnlySP(nn.Module):
    """MARN1_onlysp. Input x is time-major ``[L, B, 1024 + d_audio]`` =
    RoBERTa-1024 text | audio (100-d for IEMOCAP, 300-d for MELD, of which
    the model reads the first 100), qmask ``[L, B, P]`` one-hot over the P
    parties (2 for IEMOCAP, 9 for MELD), umask ``[B, L]``. Returns
    ``(log_probs [B*L, n_classes], x_l, x_a)`` with x_l, x_a the
    post-encoder time-major features."""

    d_r = 1024
    d_m = 100
    dropout_rate = 0.5  # h_s, h_l, h_a in the recurrence
    attn_dropout = 0.2  # the per-step rank-1 attention
    # the train forward makes no host sync: a CUDA graph can hold the step
    train_graph_safe = True

    def __init__(self, n_classes: int = 6, *, generator: torch.Generator,
                 encoder_attention: str = "mha"):
        super().__init__()
        g = generator
        self.n_classes = n_classes
        self.linear_in = TorchLinear(self.d_r, self.d_m, generator=g)
        self.encoder_l = EncoderLayer(100, 40, 8, 40, 40, generator=g,
                                      attention=encoder_attention)
        self.encoder_a = EncoderLayer(100, 40, 8, 40, 40, generator=g,
                                      attention=encoder_attention)
        self.marn_cell_f = MARNCellOnlySP(generator=g)
        self.marn_cell_b = MARNCellOnlySP(generator=g)
        for name in ("w", "v", "v1", "v2"):
            self.register_parameter(name, nn.Parameter(torch.ones(1)))
        self.crossatt_l2a = CrossAttentionSeq()
        self.crossatt_a2l = CrossAttentionSeq()
        self.crossatt_l2a_1 = CrossAttentionReSeq()
        self.crossatt_a2l_1 = CrossAttentionReSeq()
        self.dropout_rec = Dropout(0.5)
        self.dropout_rec_b = Dropout(0.5)
        d_feat = 4 * 128 * 2 + 2 * 128
        # index 2 is the reference's Dropout(0.5) (nn_out_drop)
        self.nn_out = nn.Sequential(
            TorchLinear(d_feat, 32, generator=g), nn.ReLU(), Dropout(0.5),
            TorchLinear(32, n_classes, generator=g))
        self.linear = TorchLinear(d_feat, 32, generator=g)  # unused (ref :229)

    def recurrence_inputs(self, x, qmask, umask, generator=None):
        """Everything before the recurrence: ``(seqs, consts, x_l, x_a)``
        with seqs and consts in the kernel's contract, both directions
        stacked on axis 1 and 0, and x_l, x_a the encoded ``[L, B, 100]``."""
        g = generator
        x_l = self.linear_in(x[:, :, :self.d_r].transpose(0, 1))  # [B, L, 100]
        x_a = x[:, :, self.d_r:self.d_r + self.d_m].transpose(0, 1)
        # The reference applies the same encoder layer twice (shared weights).
        x_l = self.encoder_l(self.encoder_l(x_l, g), g).transpose(0, 1)  # [L, B, 100]
        x_a = self.encoder_a(self.encoder_a(x_a, g), g).transpose(0, 1)

        seqs_f, consts_f = self.marn_cell_f.gather(x_l, x_a, qmask)
        seqs_b, consts_b = self.marn_cell_b.gather(
            reverse_seq(x_l, umask), reverse_seq(x_a, umask),
            reverse_seq(qmask, umask))
        seqs = tuple(torch.stack([f, b], 1).contiguous()
                     for f, b in zip(seqs_f, seqs_b))
        consts = tuple(torch.stack([f, b]).contiguous()
                       for f, b in zip(consts_f, consts_b))
        return seqs, consts, x_l, x_a

    def forward(self, x, qmask, umask, generator: torch.Generator | None = None):
        """In train mode every dropout draws from ``generator``, which must
        be given and lie on the model's device; in eval it is not used."""
        g = train_generator(self, generator)
        seqs, consts, x_l, x_a = self.recurrence_inputs(x, qmask, umask, g)
        if self.training:
            ys = train_recurrence(seqs, consts, g, self.dropout_rate,
                                  self.attn_dropout)
        else:
            # the kernel computes in f32: under bf16 autocast (the serving
            # artifacts' bf16 and int8) its inputs widen here, and its plain
            # version on the CPU runs with autocast off, as the kernel does
            with torch.autocast(x.device.type, enabled=False), \
                    profiling.annotate("ser#recurrence"):
                ys = lsthm_onlysp_recurrence_bidir(
                    tuple(s.float() for s in seqs),
                    tuple(c.float() for c in consts))  # [L, 2, B, 512]
        h = torch.cat([self.dropout_rec(ys[:, 0], g),
                       self.dropout_rec_b(reverse_seq(ys[:, 1], umask), g)], -1)

        attn1, attn2 = attention_tail(
            (self.crossatt_l2a, self.crossatt_a2l),
            (self.crossatt_l2a_1, self.crossatt_a2l_1),
            self.w * x_l, self.v * x_a, self.v1, self.v2, g)

        head, relu, head_drop, out_layer = self.nn_out
        out = out_layer(head_drop(relu(head(torch.cat([h, attn1, attn2], -1))), g))
        logp = torch.log_softmax(out, dim=2)
        logp = logp.transpose(0, 1).reshape(-1, self.n_classes)  # [B*L, C]
        return logp, x_l, x_a
