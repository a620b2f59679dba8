"""MARN1_onlysp in plain PyTorch: the benchmark's reference of the flagship
(``model/lsthm_onlysp.py:210-320`` of the MallVilliers reference, the
default model of its ``train.py`` and ``predict.py``).

The text (the mean of four RoBERTa views, 1024 wide) goes through
``linear_in`` to 100; text and audio (100) each pass one encoder layer
twice (shared weights). Both directions of the dialogue recurrence run
over the encoded features: per step a GRU speaker memory over the current
speaker's state, then two speaker-conditioned LSTHM cells (text, audio) on
``[h, z, s]``, then the rank-1 cross attention from the text cell's memory
to the audio cell's, which gives the next z. The tail is two chains of
sequence cross attention over ``w * x_l`` and ``v * x_a`` (re-attending
with ``v1``, ``v2``), and the head is Linear(1280, 32), ReLU,
Linear(32, 6), log-softmax. Dropout (0.5 on h_s, h_l, h_a and the
recurrence outputs, 0.2 on the attention maps, 0.1 in the encoders) is
absent: see ``common``.
"""

from __future__ import annotations

import torch

from benchmark.reference import common as c

H, D_R, D_M = 128, 1024, 100
ENC = dict(n_head=8, d_k=40, d_v=40)  # EncoderLayer(100, 40, 8, 40, 40)
ENCODERS = c.MARN1_ENCODERS  # the encoder layers, each applied `encoder.passes` times
# the leaves between the loss and the last ReLU, whose gradient has no kink
SMOOTH_LEAVES = ("nn_out.3.weight", "nn_out.3.bias")


def param_table(n_classes: int = 6) -> c.ParamTable:
    t = c.ParamTable()
    for name in ("w", "v", "v1", "v2"):
        t.ones(name, (1,))
    t.linear("linear_in", D_R, D_M)
    for enc in ("encoder_l", "encoder_a"):
        t.encoder(enc, D_M, 40, 8, 40, 40)
    for cell in ("marn_cell_f", "marn_cell_b"):
        t.lsthm(f"{cell}.lsthm_l", D_M, H)
        t.lsthm(f"{cell}.lsthm_a", D_M, H)
        t.rnn_cell(f"{cell}.gru_s", 2 * D_M, H, 3)
        for unused in ("lstm_q0", "lstm_q1", "lstm_s"):
            t.rnn_cell(f"{cell}.{unused}", H, H, 4)
        t.rank1(f"{cell}.crossatt_l2a", H)
        t.rank1(f"{cell}.crossatt_a2l", H)
    for name in ("crossatt_l2a", "crossatt_a2l"):
        for part in ("Wq", "Wk", "Wv"):
            t.ones(f"{name}.{part}", (D_M, 128))
    for name in ("crossatt_l2a_1", "crossatt_a2l_1"):
        t.ones(f"{name}.Wq", (D_M, 128))
        t.ones(f"{name}.Wk", (128, 128))
        t.ones(f"{name}.Wv", (128, 128))
    d_feat = 4 * H * 2 + 2 * 128
    t.linear("nn_out.0", d_feat, 32)
    t.linear("nn_out.3", 32, n_classes)
    t.linear("linear", d_feat, 32)
    return t


def config_checks(config: dict) -> list:
    """The configuration file against this reference (``common.marn1_config_checks``)."""
    return c.marn1_config_checks(config, param_table(config["classes"]), D_R, D_M, H, ENC)


dropout_group = c.marn1_dropout_group
inputs = c.marn1_inputs


def _gather(P, cell, x_l, x_a, qmask):
    """One direction's hoisted projections and fused state weights
    ``K = [U; V; S]`` (rows h, z, s), ``b = bU + bV + bS``."""
    l, a, g = f"{cell}.lsthm_l", f"{cell}.lsthm_a", f"{cell}.gru_s"
    seqs = (torch.matmul(x_l, P[f"{l}.W.weight"].T) + P[f"{l}.W.bias"],
            torch.matmul(x_a, P[f"{a}.W.weight"].T) + P[f"{a}.W.bias"],
            torch.matmul(torch.cat([x_l, x_a], -1), P[f"{g}.weight_ih"].T) + P[f"{g}.bias_ih"],
            qmask)
    fused = lambda m: (torch.cat([P[f"{m}.{k}.weight"].T for k in "UVS"], 0),  # noqa: E731
                       P[f"{m}.U.bias"] + P[f"{m}.V.bias"] + P[f"{m}.S.bias"])
    consts = (*fused(l), *fused(a), P[f"{g}.weight_hh"].T, P[f"{g}.bias_hh"],
              P[f"{cell}.crossatt_l2a.Wq"][0], P[f"{cell}.crossatt_l2a.Wk"][0])
    return seqs, consts


def recurrence(seqs, consts):
    """Both directions stacked on axis 1 (seqs ``[T, 2, B, .]``, consts
    ``[2, .]``); returns ``[T, 2, B, 4H]`` = ``[h_l | h_a | z | h_s]``."""
    xl, xa, gx, qmask = seqs
    K_l, b_l, K_a, b_a, Whh, bhh, wq, wk = (t.unsqueeze(1) if t.ndim == 2 else t
                                            for t in consts)
    T, _, B = xl.shape[:3]
    zeros = lambda *s: xl.new_zeros(s)  # noqa: E731
    h_l, c_l, h_a, c_a, z = (zeros(2, B, H) for _ in range(5))
    q = zeros(2, B, qmask.shape[-1], H)
    ys = []
    for t in range(T):
        h_s = c.gru_step(gx[t], c.select_parties(q, qmask[t]), Whh, bhh)
        q = c.scatter_parties(q, qmask[t], h_s)
        c_l, h_l = c.lsthm_gates(xl[t] + torch.matmul(torch.cat([h_l, z, h_s], -1), K_l) + b_l, c_l)
        c_a, h_a = c.lsthm_gates(xa[t] + torch.matmul(torch.cat([h_a, z, h_s], -1), K_a) + b_a, c_a)
        z = c.rank1_attention(c_l, c_a, wq, wk)
        ys.append(torch.cat([h_l, h_a, z, h_s], -1))
    return torch.stack(ys)


def forward(P, x, qmask, umask):
    """Log-probabilities ``[B*L, C]`` (batch-major rows) of x ``[L, B,
    1024 + 100]`` (text mean | audio), qmask ``[L, B, P]``, umask ``[B, L]``."""
    enc = lambda name, u: c.encoder(P, name, c.encoder(P, name, u, **ENC), **ENC)  # noqa: E731
    x_l = c.linear(P, "linear_in", x[:, :, :D_R].transpose(0, 1))
    x_a = x[:, :, D_R:D_R + D_M].transpose(0, 1)
    x_l = enc("encoder_l", x_l).transpose(0, 1)
    x_a = enc("encoder_a", x_a).transpose(0, 1)
    rev = lambda u: c.reverse_seq(u, umask)  # noqa: E731
    sf, cf = _gather(P, "marn_cell_f", x_l, x_a, qmask)
    sb, cb = _gather(P, "marn_cell_b", rev(x_l), rev(x_a), rev(qmask))
    seqs = tuple(torch.stack([f, b], 1) for f, b in zip(sf, sb))
    consts = tuple(torch.stack([f, b]) for f, b in zip(cf, cb))
    ys = recurrence(seqs, consts)
    h = torch.cat([ys[:, 0], rev(ys[:, 1])], -1)
    xf, xs = P["w"] * x_l, P["v"] * x_a
    attn1 = c.cross_attention_seq(P, "crossatt_l2a", xf, xs)
    attn2 = c.cross_attention_seq(P, "crossatt_a2l", xs, xf)
    attn1 = c.cross_attention_seq(P, "crossatt_l2a_1", xs, P["v1"] * attn1)
    attn2 = c.cross_attention_seq(P, "crossatt_a2l_1", xf, P["v2"] * attn2)
    hid = torch.relu(c.linear(P, "nn_out.0", torch.cat([h, attn1, attn2], -1)))
    logp = torch.log_softmax(c.linear(P, "nn_out.3", hid), dim=-1)
    return logp.transpose(0, 1).reshape(-1, logp.shape[-1])


def matmul_flops(L: int, B: int, train: bool) -> int:
    """The matrix-product FLOPs (2 a multiply-add) that
    ``torch.utils.flop_counter.FlopCounterMode`` counts in ``forward`` at
    [L, B], and with ``train`` in the forward and the backward of one train
    step (gradients of the parameters, not of the input). N = L * B rows.
    Forward, by a row: linear_in 204,800; four encoder passes of 272,000
    (q, k, v 3 x 64,000, out 64,000, FFN 16,000) and 1,280 * L for their
    two attention contractions; the two directions' hoisted projections
    716,800; a recurrence step 1,770,496 (the GRU's h side 196,608, the two
    LSTHM products 786,432 each, the speaker select 1,024); the tail 335,872
    and 2,048 * L; the head 82,304. The backward counts two products for
    each forward one, less the input gradients that no parameter needs
    (linear_in's, the audio encoder's first q, k and v products and the
    speaker select's one-hot: 397,824 a row) and the first step's
    products of the zero state (197,632 a batch row). The terms are fitted
    to the counter's totals at five shapes, and ``benchmark/tests`` holds
    them at two more. At [82, 31] the forward is 12,166,134,016 and at
    [110, 80] a step 128,133,591,040: the counts of the program's own plain
    path (``ser_tpu_torch/utils/flops.py``) at those shapes."""
    N = L * B
    fwd = 4_198_272 * N + 7_168 * B * L * L
    if not train:
        return fwd
    return 3 * fwd - 397_824 * N - 197_632 * B


def rank1_calls(L: int, train: bool):
    """``(forward, backward)`` evaluations of the rank-1 attention at [2, B,
    128] in a pass at L: one a step, and in a train step one backward a step
    (every z reaches the output)."""
    return L, (L if train else 0)

