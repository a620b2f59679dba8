"""MARN1_nsps in plain PyTorch: the benchmark's reference of the variant
with a GRU speaker, a listener and the learnable fusion ``p``
(``model/lsthm_nsps.py:242-375`` of the MallVilliers reference).

The text mean goes through ``linear_in`` to 100; text and audio each pass
a residual-stacked encoder ``enc(x + enc(x))``. Per recurrence step, both
directions at once: a GRU on the speaker's memory with the 200-wide
``[x_l | x_a]`` from before the encoders, the listener's memory (party
``(1 - argmax qmask) mod P``) carried to the non-speaker slots, the text
and audio LSTHM cells on ``[h, z, h_s]`` and the rank-1 cross attention,
whose z feeds the next step only. The tail is two sequence cross
attentions with a residual and LayerNorm, the halves ``[h_l | attn2]`` and
``[h_a | attn1]`` weighted by ``softmax(p)``, plus ``ReLU(fc(x_l))``, and
the head Linear(712, 32), ReLU, Linear(32, 6), log-softmax. Dropout is
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
    t.ones("p", (2,))
    t.linear("linear_in", D_R, D_M)
    for enc in ("encoder_l", "encoder_a"):
        t.encoder(enc, D_M, 40, 8, 40, 40)
    for cell in ("marn_cell_f", "marn_cell_b"):
        t.lsthm(f"{cell}.lsthm_l", D_M, H)
        t.lsthm(f"{cell}.lsthm_a", D_M, H)
        t.rank1(f"{cell}.crossatt_l2a", H)
        t.rank1(f"{cell}.crossatt_a2l", H)
        t.rnn_cell(f"{cell}.gru_s", 2 * D_M, H, 3)
        t.rnn_cell(f"{cell}.gru_l", 2 * D_M, H, 3)
    for name in ("crossatt_l2a", "crossatt_a2l"):
        for part in ("Wq", "Wk", "Wv"):
            t.ones(f"{name}.{part}", (D_M, D_M))
        t.layer_norm(f"{name}.layer_norm", D_M)
    d_feat = 2 * (2 * H + D_M)
    t.linear("fc.0", D_M, d_feat)
    t.linear("fc2.0", D_M, d_feat)
    t.linear("nn_out.0", d_feat, 32)
    t.linear("nn_out.3", 32, n_classes)
    return t


def config_checks(config: dict) -> list:
    """The configuration file against this reference (``common.marn1_config_checks``)."""
    return c.marn1_config_checks(config, param_table(config["classes"]), D_R, D_M, H, ENC)


dropout_group = c.marn1_dropout_group
inputs = c.marn1_inputs


def _gather(P, cell, xcat, x_l, x_a, qmask):
    l, a, g = f"{cell}.lsthm_l", f"{cell}.lsthm_a", f"{cell}.gru_s"
    seqs = (c.linear(P, f"{l}.W", x_l), c.linear(P, f"{a}.W", x_a),
            torch.matmul(xcat, P[f"{g}.weight_ih"].T) + P[f"{g}.bias_ih"], qmask)
    fused = lambda m: (torch.cat([P[f"{m}.{k}.weight"].T for k in "UVS"], 0),  # noqa: E731
                       (P[f"{m}.U.bias"] + P[f"{m}.V.bias"] + P[f"{m}.S.bias"])[None])
    consts = (*fused(l), *fused(a), P[f"{g}.weight_hh"].T, P[f"{g}.bias_hh"][None],
              P[f"{cell}.crossatt_l2a.Wq"][0], P[f"{cell}.crossatt_l2a.Wk"][0])
    return seqs, consts


def listener(q, qmask_t):
    """The listener's memory, party ``(1 - argmax qmask) mod P`` (the
    reference's ``q[1 - idx]`` with Python's negative index)."""
    P = q.shape[-2]
    other = torch.remainder(1 - qmask_t.argmax(-1), P)
    onehot = (other[..., None] == torch.arange(P, device=q.device)).to(q.dtype)
    return torch.einsum("...p,...pd->...d", onehot, q)


def recurrence(seqs, consts):
    """Both directions stacked; returns ``[T, 2, B, 2H]`` = ``[h_l | h_a]``."""
    xl, xa, gx, qmask = seqs
    K_l, b_l, K_a, b_a, Whh, bhh, wq, wk = consts
    wq, wk = wq[:, None], wk[:, None]
    T, _, B = xl.shape[:3]
    zeros = lambda *s: xl.new_zeros(s)  # noqa: E731
    h_l, c_l, h_a, c_a, z = (zeros(2, B, H) for _ in range(5))
    q = zeros(2, B, qmask.shape[-1], H)
    ys = []
    for t in range(T):
        qm = qmask[t][..., None]
        h_s = c.gru_step(gx[t], c.select_parties(q, qmask[t]), Whh, bhh)
        q = listener(q, qmask[t])[..., None, :] * (1.0 - qm) + h_s[..., None, :] * qm
        c_l, h_l = c.lsthm_gates(xl[t] + torch.matmul(torch.cat([h_l, z, h_s], -1), K_l) + b_l, c_l)
        c_a, h_a = c.lsthm_gates(xa[t] + torch.matmul(torch.cat([h_a, z, h_s], -1), K_a) + b_a, c_a)
        z = c.rank1_attention(c_l, c_a, wq, wk)
        ys.append(torch.cat([h_l, h_a], -1))
    return torch.stack(ys)


def forward(P, x, qmask, umask):
    """Log-probabilities ``[B*L, C]`` (batch-major rows) of x ``[L, B,
    1024 + 100]``, qmask ``[L, B, P]``, umask ``[B, L]``."""
    enc = lambda name, u: c.encoder(P, name, u + c.encoder(P, name, u, **ENC), **ENC)  # noqa: E731
    x_l = c.linear(P, "linear_in", x[:, :, :D_R].transpose(0, 1))
    x_a = x[:, :, D_R:D_R + D_M].transpose(0, 1)
    xcat = torch.cat([x_l, x_a], 2).transpose(0, 1)
    x_l = enc("encoder_l", x_l).transpose(0, 1)
    x_a = enc("encoder_a", x_a).transpose(0, 1)
    rev = lambda u: c.reverse_seq(u, umask)  # noqa: E731
    sf, cf = _gather(P, "marn_cell_f", xcat, x_l, x_a, qmask)
    sb, cb = _gather(P, "marn_cell_b", rev(xcat), rev(x_l), rev(x_a), rev(qmask))
    seqs = [torch.stack([f, b], 1) for f, b in zip(sf, sb)]
    consts = [torch.stack([f, b]) for f, b in zip(cf, cb)]
    ys = recurrence(seqs, consts)
    h_f, h_b = ys[:, 0], rev(ys[:, 1])
    h_l = torch.cat([h_f[..., :H], h_b[..., :H]], -1)
    h_a = torch.cat([h_f[..., H:], h_b[..., H:]], -1)
    ln = lambda name, a, b: c.layer_norm(  # noqa: E731
        P, f"{name}.layer_norm", c.cross_attention_seq(P, name, a, b) + a)
    attn1 = ln("crossatt_l2a", x_l, x_a)
    attn2 = ln("crossatt_a2l", x_a, x_l)
    pw = torch.softmax(P["p"], 0)
    resid = torch.relu(c.linear(P, "fc.0", x_l))
    feats = torch.cat([pw[0] * torch.cat([h_l, attn2], -1),
                       pw[1] * torch.cat([h_a, attn1], -1)], -1) + resid
    logp = torch.log_softmax(c.linear(P, "nn_out.3", torch.relu(c.linear(P, "nn_out.0", feats))),
                             dim=-1)
    return logp.transpose(0, 1).reshape(-1, logp.shape[-1])


def matmul_flops(L: int, B: int, train: bool) -> int:
    """The matrix-product FLOPs that ``FlopCounterMode`` counts in
    ``forward`` at [L, B], and with ``train`` in one train step's forward
    and backward (gradients of the parameters). Fitted to the counter's
    totals at five shapes; ``benchmark/tests`` holds them at two more.
    The forward is 4,089,472 a row and 5,920 * L a row for the encoders'
    and the tail's attention contractions; the backward counts two products
    for each forward one, less the input gradients no parameter needs
    (398,848 a row) and the first step's products of the zero state
    (199,680 a batch row)."""
    N = L * B
    fwd = 4_089_472 * N + 5_920 * B * L * L
    if not train:
        return fwd
    return 3 * fwd - 398_848 * N - 199_680 * B


def rank1_calls(L: int, train: bool):
    """``(forward, backward)`` evaluations of the rank-1 attention at [2, B,
    128] in a pass at L: one a step; the last step's z reaches no output, so
    a train step runs L - 1 backwards."""
    return L, (L - 1 if train else 0)
