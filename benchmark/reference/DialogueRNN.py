"""DialogueRNN in plain PyTorch: the benchmark's reference of the
bidirectional model ``BiModel`` (Majumder et al., AAAI 2019,
arXiv:1811.00405; ``model/DialogueRNN.py:80-277`` of the MallVilliers
reference, built as ``model_trainer.py:35-47`` builds it: D_m = 712, D_g =
D_p = 500, D_e = D_h = 300, listener state on, 'general' context
attention, 6 classes).

Written from the published module, step by step as it runs, not from the
program's reformulation. Each direction loops over the utterances. A step
(``DialogueRNNCell.forward``) selects the speaker's party state by
``argmax(qmask)`` (a padded, all-zero row is party 0); runs the global
``nn.GRUCell`` on ``[u | q_speaker]`` from the last global state (zeros at
the first step); attends over the global states of the earlier steps with
'general' ``MatchingAttention`` (``softmax(transform(u) . g_hist)``, no
bias, no mask; at the first step no attention and a zero context); runs
the party GRU on ``[u | c]`` for every party's row, the listener GRU on
``[u | the speaker's new state]`` for every party's row, mixes them by
qmask (speaker rows from the party GRU, the others from the listener's)
and runs the emotion GRU on the speaker's mixed state. Every GRU is
``nn.GRUCell``'s equations on its concatenated input, one product a side.
The party and the listener GRUs give every party row of a dialogue the
same input, which the published code expands before the product: here the
input's product is taken once a dialogue and its result expanded, the
same numbers without the products that repeat a row.
The backward direction runs on the mask-aware reversal of u and qmask
(``_reverse_seq``: each dialogue's valid steps reversed, its padded tail
zero) and its emotions are reversed back. The tail is 'general2'
``MatchingAttention`` for each query step over every step of the
concatenated emotions (``softmax(scores * mask) * mask``, renormalised),
then ``relu(linear)``, ``smax_fc`` and ``log_softmax``.

Departures from the published code: none in the function; dropout is
absent (see ``common``), the repeated input rows' product is taken once
(above), and the rows come out batch-major, the order of
the program's ``[B*L, C]`` output. The check computes it in float64,
where TF32 does not apply; the harness runs with TF32 off besides
(``benchmark.run.set_precision``) but for the control.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference import common as c

D_M, D_G, D_P, D_E, D_H = 712, 500, 500, 300, 300
TEXT = 100  # the RoBERTa mean's first dims in the trimodal input
PARTIES = 2
DIRECTIONS = ("dialog_rnn_f", "dialog_rnn_r")
# the leaves between the loss and the head's ReLU, whose gradient has no kink
SMOOTH_LEAVES = ("smax_fc.weight", "smax_fc.bias")


def param_table(n_classes: int = 6, D_m=D_M, D_g=D_G, D_p=D_P, D_e=D_E, D_h=D_H) -> c.ParamTable:
    """The parameters at the published widths, or at the widths given (the
    tests' small ones); the functions below read the widths from them."""
    t = c.ParamTable()
    for rnn in DIRECTIONS:
        cell = f"{rnn}.dialogue_cell"
        t.rnn_cell(f"{cell}.g_cell", D_m + D_p, D_g, 3)
        t.rnn_cell(f"{cell}.p_cell", D_m + D_g, D_p, 3)
        t.rnn_cell(f"{cell}.e_cell", D_p, D_e, 3)
        t.rnn_cell(f"{cell}.l_cell", D_m + D_p, D_p, 3)
        t.linear(f"{cell}.attention.transform", D_m, D_g, bias=False)
    t.linear("linear", 2 * D_e, 2 * D_h)
    t.linear("smax_fc", 2 * D_h, n_classes)
    t.linear("matchatt.transform", 2 * D_e, 2 * D_e)
    return t


def config_checks(config: dict) -> list:
    """The configuration file against this reference, as ``(what, one side,
    the other)`` triples whose sides must be equal."""
    table = {n: shape for n, (shape, _, _) in param_table(config["classes"]).items()}
    cell = "dialog_rnn_f.dialogue_cell"
    g_gates, D_g = table[f"{cell}.g_cell.weight_hh"]
    D_p = table[f"{cell}.p_cell.weight_hh"][1]
    D_e = table[f"{cell}.e_cell.weight_hh"][1]
    D_h2, D_e2 = table["linear.weight"]
    attention = table[f"{cell}.attention.transform.weight"]
    return [
        ("input_width, text 100, audio and visual", config["input_width"],
         TEXT + config["audio_width"] + config["visual_width"]),
        ("the global GRU's input, D_m + D_p", table[f"{cell}.g_cell.weight_ih"][1],
         config["input_width"] + config["D_p"]),
        ("the global GRU's three gates", g_gates, 3 * D_g),
        ("D_g", D_g, config["D_g"]),
        ("D_p", D_p, config["D_p"]),
        ("D_e", D_e, config["D_e"]),
        ("D_h, the head's half width", D_h2, 2 * config["D_h"]),
        ("the emotions of both directions", D_e2, 2 * D_e),
        ("listener_state, an l_cell", f"{cell}.l_cell.weight_ih" in table,
         config["listener_state"]),
        ("the context attention", config["context_attention"], "general"),
        ("'general''s transform, D_m -> D_g without bias",
         (attention, f"{cell}.attention.transform.bias" in table),
         ((config["D_g"], config["input_width"]), False)),
        ("the head's classes", table["smax_fc.weight"][0], config["classes"]),
        ("the parties", config["parties"], PARTIES),
        ("the text views' width holds the trimodal text", config["text_width"] >= TEXT, True),
    ]


def dropout_group(module: str) -> str:
    """The configuration's dropout key of a program module's rate: the
    cells' float rate (``.dropout_rate`` of the model), the emotions'
    ``dropout_rec`` and the head's ``dropout``."""
    return {".dropout_rate": "cells", "dropout_rec": "emotions", "dropout": "head"}[module]


def inputs(batch, config):
    """x ``[L, B, 712]`` in float64: the text views' mean's first 100 dims,
    the audio, the visual features."""
    text = c.text_mean({k: batch[k].double() for k in batch if k.startswith("r")},
                       views=config["text_views"])
    return torch.cat([text[..., :TEXT], batch["acouf"].double(), batch["visuf"].double()], -1)


def gru_cell(P, name, x, h):
    """``nn.GRUCell``: gates r, z, n; r multiplies the h side of n. x
    ``[B, D]`` may have fewer rows than h ``[B*P, H]``: one input for each
    dialogue's P party rows, its product repeated to them."""
    gi = F.linear(x, P[f"{name}.weight_ih"], P[f"{name}.bias_ih"])
    if gi.shape[0] != h.shape[0]:
        gi = gi.repeat_interleave(h.shape[0] // gi.shape[0], 0)
    gh = F.linear(h, P[f"{name}.weight_hh"], P[f"{name}.bias_hh"])
    i_r, i_z, i_n = gi.chunk(3, -1)
    h_r, h_z, h_n = gh.chunk(3, -1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1 - z) * n + z * h


def select_parties(X, idx):
    """``X[b, idx[b]]`` for each row b: X ``[B, P, D]``."""
    return X[torch.arange(X.shape[0], device=X.device), idx]


def context(P, cell, U, g_hist):
    """``MatchingAttention`` 'general' of u over the earlier global states
    ``[t, B, D_g]``: ``softmax(transform(u) . g_hist)`` pools them, no mask;
    at the first step (no earlier state) the context is zero."""
    if g_hist.shape[0] == 0:
        return U.new_zeros(U.shape[0], g_hist.shape[-1])
    x_ = F.linear(U, P[f"{cell}.attention.transform.weight"])[:, None]  # [B, 1, D_g]
    alpha = torch.softmax(torch.bmm(x_, g_hist.permute(1, 2, 0)), dim=2)  # [B, 1, t]
    return torch.bmm(alpha, g_hist.transpose(0, 1))[:, 0]


def dialogue_cell(P, cell, U, qmask, g_hist, q0, e0):
    """One step of ``DialogueRNNCell``: U ``[B, D_m]``, qmask ``[B, P]``,
    g_hist the earlier global states ``[t, B, D_g]``, q0 ``[B, P, D_p]``,
    e0 ``[B, D_e]`` or None at the first step. Returns ``(g, q, e)``."""
    B, n_parties, D_p = q0.shape
    D_e = P[f"{cell}.e_cell.weight_hh"].shape[1]
    idx = torch.argmax(qmask, 1)
    q0_sel = select_parties(q0, idx)
    g_prev = U.new_zeros(B, g_hist.shape[-1]) if g_hist.shape[0] == 0 else g_hist[-1]
    g_ = gru_cell(P, f"{cell}.g_cell", torch.cat([U, q0_sel], 1), g_prev)
    c_ = context(P, cell, U, g_hist)
    qs_ = gru_cell(P, f"{cell}.p_cell", torch.cat([U, c_], 1),
                   q0.reshape(B * n_parties, D_p)).reshape(B, n_parties, D_p)
    ql_ = gru_cell(P, f"{cell}.l_cell", torch.cat([U, select_parties(qs_, idx)], 1),
                   q0.reshape(B * n_parties, D_p)).reshape(B, n_parties, D_p)
    qmask_ = qmask[:, :, None]
    q_ = ql_ * (1 - qmask_) + qs_ * qmask_
    e_ = gru_cell(P, f"{cell}.e_cell", select_parties(q_, idx),
                  U.new_zeros(B, D_e) if e0 is None else e0)
    return g_, q_, e_


def direction(P, rnn, U, qmask):
    """``DialogueRNN.forward``: the emotions ``[L, B, D_e]``."""
    cell = f"{rnn}.dialogue_cell"
    D_g = P[f"{cell}.g_cell.weight_hh"].shape[1]
    D_p = P[f"{cell}.p_cell.weight_hh"].shape[1]
    g_hist = U.new_zeros(0, U.shape[1], D_g)
    q_ = U.new_zeros(qmask.shape[1], qmask.shape[2], D_p)
    e_, es = None, []
    for u_, qmask_ in zip(U, qmask):
        g_, q_, e_ = dialogue_cell(P, cell, u_, qmask_, g_hist, q_, e_)
        g_hist = torch.cat([g_hist, g_[None]], 0)
        es.append(e_)
    return torch.stack(es)


def matching_attention_general2(P, M, x, mask):
    """``MatchingAttention`` 'general2': M ``[L, B, D]``, x ``[B, D]``, mask
    ``[B, L]``; the pooled ``[B, D]``."""
    M_ = M.permute(1, 2, 0)
    x_ = c.linear(P, "matchatt.transform", x)[:, None]
    alpha_ = torch.softmax(torch.bmm(x_, M_) * mask[:, None], dim=2)
    alpha_masked = alpha_ * mask[:, None]
    alpha = alpha_masked / alpha_masked.sum(2, keepdim=True)
    return torch.bmm(alpha, M.transpose(0, 1))[:, 0]


def forward(P, x, qmask, umask):
    """Log-probabilities ``[B*L, C]`` (batch-major rows) of x ``[L, B,
    712]``, qmask ``[L, B, P]``, umask ``[B, L]``."""
    emotions_f = direction(P, DIRECTIONS[0], x, qmask)
    rev = lambda u: c.reverse_seq(u, umask)  # noqa: E731
    emotions_b = rev(direction(P, DIRECTIONS[1], rev(x), rev(qmask)))
    emotions = torch.cat([emotions_f, emotions_b], -1)
    att_emotions = torch.stack([matching_attention_general2(P, emotions, t, umask)
                                for t in emotions])
    hidden = torch.relu(c.linear(P, "linear", att_emotions))
    log_prob = torch.log_softmax(c.linear(P, "smax_fc", hidden), dim=2)
    return log_prob.transpose(0, 1).reshape(-1, log_prob.shape[-1])


def matmul_flops(L: int, B: int, train: bool) -> int:
    """The matrix-product FLOPs that ``FlopCounterMode`` counts in
    ``forward`` at [L, B], and with ``train`` in one train step's forward
    and backward (gradients of the parameters). Each term is 2 FLOPs a
    multiply-add; the counts are the counter's at every shape that
    ``benchmark/tests`` and ``tests/test_torch_drnn_reference.py`` try.

    A direction's step, on B rows and the B·P party rows (P = 2): the
    global GRU ``2B(D_m + D_p + D_g)3D_g``, the party and the listener GRUs
    ``2B(D_m + D_g)3D_p + 2BP·D_p·3D_p`` each (D_g = D_p; the input's
    product once a dialogue, the state's on every party row), the emotion GRU
    ``2B(D_p + D_e)3D_e``; from the second step on the attention's
    transform ``2B·D_m·D_g``, and over t earlier states its scores and its
    pool ``4B·t·D_g``, ``4·B·D_g·L(L-1)/2`` a direction. The tail: for each
    of the L queries the transform ``2B(2D_e)²`` and the scores and pool
    over L steps ``4B·L·2D_e``; the head ``2BL(2D_e·2D_h + 2D_h·C)``.

    The backward counts two products for each forward one, less those
    that reach no parameter (``_backward_saving``)."""
    steps, t_pairs = L * B, B * L * (L - 1) // 2
    C = 6
    g = 2 * (D_M + D_P + D_G) * 3 * D_G
    party = 2 * (D_M + D_G) * 3 * D_P + 2 * PARTIES * D_P * 3 * D_P
    emotion = 2 * (D_P + D_E) * 3 * D_E
    per_step = g + 2 * party + emotion
    attention = 2 * (L - 1) * B * D_M * D_G + 4 * t_pairs * D_G
    tail = L * (2 * B * (2 * D_E) ** 2 + 4 * B * L * 2 * D_E)
    head = 2 * L * B * (2 * D_E * 2 * D_H + 2 * D_H * C)
    fwd = 2 * (steps * per_step + attention) + tail + head
    if not train:
        return fwd
    return 3 * fwd - _backward_saving(L, B)


def _backward_saving(L: int, B: int) -> int:
    """The backward's products that the counter does not count, a
    direction: at the first step the input gradient of the global GRU's
    ``[u | 0]`` and of the party GRU's ``[u | 0]`` (zero context) and the
    state gradient of every GRU's zero state; the whole backward of the
    last step's global GRU, whose state no later step reads; and the input
    gradient of each attention transform's u, from the second step on."""
    first_row = (2 * (D_M + D_P) * 3 * D_G + 2 * D_G * 3 * D_G
                 + 2 * (D_M + D_G) * 3 * D_P + 2 * 2 * PARTIES * D_P * 3 * D_P
                 + 2 * D_E * 3 * D_E)
    last_global = 2 * 2 * (D_M + D_P + D_G) * 3 * D_G
    transform_input = 2 * D_M * D_G
    return 2 * (B * (first_row + last_global) + (L - 1) * B * transform_input)
