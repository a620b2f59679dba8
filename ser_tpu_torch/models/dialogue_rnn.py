"""DialogueRNN (counterpart of ``ser_tpu/models/dialogue_rnn.py``; ref
``model/DialogueRNN.py``).

``BiModel`` is the registry's bidirectional model: D_m = 712 (the trimodal
input, text 100 + audio 100 + visual 512), D_g = D_p = 500, D_e = D_h =
300, listener state on, 'general' context attention (a Linear D_m -> D_g
without bias), dropout 0.1 in the cells and on the head, 0.25 on the
emotion sequences, 6 classes. A direction (``DialogueRNN``) also takes the
JAX class's other configurations, which the models of
``dialogue_rnn_extras.py`` use: 'simple' context attention (the reference's
``SimpleAttention``, a ``Linear(D_g, 1)`` without bias scoring the global
states, ``attention.scalar``), 'general2' (the transform with its bias) and
no listener state (no ``l_cell``; a listener's party state stays as it
was).

Each direction (``DialogueRNN``, whose ``dialogue_cell`` holds the GRU
cells g, p, e, l and the attention under the reference's names) hoists its
x-side projections over all steps (``gather``); the directions then run
stacked on a leading axis of 1 or 2 in one Python loop over T
(``recurrence``, the JAX package's per-step ``_drnn_step`` with the
P-generic party update). A step: the speaker's party state selected by
``argmax(qmask)`` (an all-zero padded row picks party 0), the global-state
GRU, the context attention over the global states written so far, the
party GRU on all B·P rows, with listener state the listener GRU on all B·P
rows from the speaker's new state, the qmask mix, the emotion GRU; in train
a dropout after each of those GRUs (g, the party rows, the listener rows,
e), drawn in that order.

The history is the list of the steps' global states, stacked to the prefix
``[2, B, t, D_g]`` at each step: the softmax over it needs no mask (an empty
prefix at t = 0 gives a zero context and a zero alpha), and autograd keeps
one prefix a step, about half of what a fixed ``[L, ...]`` buffer read
every step would keep. The JAX package's TPU reformulations (the chunked
online-softmax step, on once L >= 32, and the P = 2 kept-rows path) compute
the same function on every valid step; the tests compare valid rows.
"""

from __future__ import annotations

from functools import partial

import torch
import torch.nn.functional as F
from torch import nn

from ser_tpu_torch.ops.cells import RNNCellWeights, gru_step
from ser_tpu_torch.ops.layers import Dropout, TorchLinear, dropout, train_generator
from ser_tpu_torch.ops.masking import reverse_seq, select_parties
from ser_tpu_torch.utils import profiling


class MatchingAttention(nn.Module):
    """The parameters of the reference's ``MatchingAttention``: ``transform``
    ``Linear(d_in, d_out)``, without bias for 'general', with it for
    'general2'."""

    def __init__(self, d_in: int, d_out: int, bias: bool, *, generator: torch.Generator):
        super().__init__()
        self.transform = TorchLinear(d_in, d_out, bias=bias, generator=generator)


class SimpleAttention(nn.Module):
    """The parameters of the reference's ``SimpleAttention``: ``scalar``,
    ``Linear(D_g, 1)`` without bias."""

    def __init__(self, D_g: int, *, generator: torch.Generator):
        super().__init__()
        self.scalar = TorchLinear(D_g, 1, bias=False, generator=generator)


CONTEXT_ATTENTIONS = ("simple", "general", "general2")


class DialogueCell(nn.Module):
    """The parameters of ``DialogueRNNCell``: the GRU cells g (on [U, q],
    D_m + D_p -> D_g), p (on [U, c], D_m + D_g -> D_p), e (D_p -> D_e),
    with ``listener_state`` l (on [U, s], D_m + D_p -> D_p), and the
    context attention: 'simple' (``SimpleAttention``), 'general' (the
    transform without bias) or 'general2' (with it). Another kind raises
    ``ValueError``."""

    def __init__(self, D_m: int, D_g: int, D_p: int, D_e: int, listener_state: bool = True,
                 context_attention: str = "general", *, generator: torch.Generator):
        super().__init__()
        if context_attention not in CONTEXT_ATTENTIONS:
            raise ValueError(f"unknown context_attention: {context_attention}")
        g = generator
        self.g_cell = RNNCellWeights(D_m + D_p, D_g, 3, generator=g)
        self.p_cell = RNNCellWeights(D_m + D_g, D_p, 3, generator=g)
        self.e_cell = RNNCellWeights(D_p, D_e, 3, generator=g)
        if listener_state:
            self.l_cell = RNNCellWeights(D_m + D_p, D_p, 3, generator=g)
        self.attention = (SimpleAttention(D_g, generator=g) if context_attention == "simple"
                          else MatchingAttention(D_m, D_g, context_attention == "general2",
                                                 generator=g))


class DialogueRNN(nn.Module):
    """One direction's parameters (``dialog_rnn``, ``dialog_rnn_f``,
    ``dialog_rnn_r``)."""

    def __init__(self, D_m: int, D_g: int, D_p: int, D_e: int, listener_state: bool = True,
                 context_attention: str = "general", *, generator: torch.Generator):
        super().__init__()
        self.dialogue_cell = DialogueCell(D_m, D_g, D_p, D_e, listener_state,
                                          context_attention, generator=generator)

    def gather(self, U, qmask):
        """``(seqs, consts)`` of ``recurrence`` for this direction: seqs
        ``[qmask, g_x, p_x, l_x, att_x]``, the x-side projections of U
        ``[T, B, D_m]`` over all steps (GRU input biases in), ``l_x`` None
        without listener state and ``att_x`` None for 'simple'; consts the
        state-side kernels ``[in, out]`` and biases ``[1, out]`` of g, p, e
        and l (l's three None without listener state), then for 'simple'
        its scoring vector ``[D_g, 1]``."""
        cell = self.dialogue_cell
        D_m = U.shape[-1]

        def x_side(c):
            return F.linear(U, c.weight_ih[:, :D_m], c.bias_ih)

        def hh(c):
            return c.weight_hh.T, c.bias_hh[None]

        gc, pc, ec = cell.g_cell, cell.p_cell, cell.e_cell
        lc = getattr(cell, "l_cell", None)
        simple = isinstance(cell.attention, SimpleAttention)
        seqs = [qmask, x_side(gc), x_side(pc), None if lc is None else x_side(lc),
                None if simple else cell.attention.transform(U)]
        consts = [gc.weight_ih[:, D_m:].T, *hh(gc), pc.weight_ih[:, D_m:].T, *hh(pc),
                  ec.weight_ih.T, ec.bias_ih[None], *hh(ec),
                  *((None,) * 3 if lc is None else (lc.weight_ih[:, D_m:].T, *hh(lc)))]
        if simple:
            consts.append(cell.attention.scalar.weight.T)
        return seqs, consts

    def forward(self, U, qmask, drop=lambda v: v):
        """This direction alone: ``(emotions [T, B, D_e], alpha [T, B,
        T])``; ``drop`` is the cells' dropout (the identity in eval)."""
        seqs, consts = self.gather(U, qmask)
        es, alphas = recurrence(_stack([consts]), _stack([seqs], 1), drop)
        return es[:, 0], alphas[:, 0]


def _stack(directions, dim=0):
    """Each entry of the directions' seqs or consts stacked on ``dim``
    (None stays None)."""
    return [None if ts[0] is None else torch.stack(ts, dim) for ts in zip(*directions)]


def _party_gru(x_proj, q, hh_kernel, hh_bias):
    """A GRU step on every party row, each party of a row given the row's
    input: x_proj ``[n, B, 3D]``, q ``[n, B, P, D]``; returns ``[n, B, P,
    D]``."""
    n, B, P, D = q.shape
    x = x_proj[:, :, None].expand(n, B, P, x_proj.shape[-1]).reshape(n, B * P, -1)
    return gru_step(x, q.reshape(n, B * P, D), hh_kernel, hh_bias).reshape(n, B, P, D)


def drnn_step(consts, carry, xs, drop):
    """One step of n stacked directions: carry ``(q [n, B, P, D_p], e [n,
    B, D_e], g [n, B, D_g], history)``, the history a list of the earlier
    steps' ``[n, B, D_g]`` global states; xs this step's seqs. Returns
    ``(carry, (e, alpha [n, B, t]))``."""
    (gWq, gWhh, gbhh, pWc, pWhh, pbhh, eWih, ebih, eWhh, ebhh, lWs, lWhh, lbhh,
     *simple) = consts
    q, e, g, hist = carry
    qm, g_x, p_x, l_x, att_x = xs
    q0 = select_parties(q, qm)
    g_ = drop(gru_step(g_x + torch.matmul(q0, gWq), g, gWhh, gbhh))
    if hist:
        M = torch.stack(hist, 2)  # [n, B, t, D_g]
        query = simple[0][:, None] if simple else att_x[..., None]
        alpha = torch.softmax(torch.matmul(M, query)[..., 0], -1)
        p_in = p_x + torch.matmul(torch.matmul(alpha[..., None, :], M)[..., 0, :], pWc)
    else:  # an empty prefix: the context is zero
        alpha, p_in = g_.new_zeros(g_.shape[:2] + (0,)), p_x
    qs_ = drop(_party_gru(p_in, q, pWhh, pbhh))
    if lWs is None:  # no listener state: a listener's party state stays as it was
        ql_ = q
    else:
        ql_ = drop(_party_gru(l_x + torch.matmul(select_parties(qs_, qm), lWs), q, lWhh, lbhh))
    m = qm[..., None]
    q_ = ql_ * (1.0 - m) + qs_ * m
    e_ = drop(gru_step(torch.matmul(select_parties(q_, qm), eWih) + ebih, e, eWhh, ebhh))
    return (q_, e_, g_, hist + [g_]), (e_, alpha)


def recurrence(consts, seqs, drop):
    """``drnn_step`` over all T steps from a zero carry: a Python loop over
    n stacked directions (1 or 2), seqs ``[T, n, B, ...]``, consts ``[n,
    ...]``, inside the span ``ser#recurrence``. Returns the emotions ``[T,
    n, B, D_e]`` and the context attentions ``[T, n, B, T]`` (step t's over
    steps 0..t-1, zeros after)."""
    T, n, B, P = seqs[0].shape
    D_g, D_p, D_e = consts[1].shape[-2], consts[4].shape[-2], consts[8].shape[-2]
    new = seqs[1].new_zeros
    carry = (new(n, B, P, D_p), new(n, B, D_e), new(n, B, D_g), [])
    es, alphas = [], []
    with profiling.annotate("ser#recurrence"):
        for t in range(T):
            carry, (e, alpha) = drnn_step(consts, carry,
                                          [None if s is None else s[t] for s in seqs], drop)
            es.append(e)
            alphas.append(F.pad(alpha, (0, T - t)))
    return torch.stack(es), torch.stack(alphas)


def bidirectional(rnn_f, rnn_r, U, qmask, umask, drop):
    """Both directions stacked in one ``recurrence``, the reverse one on
    the mask-aware reversal of U and qmask: ``(emotions_f, emotions_b,
    alpha_f, alpha_b)``, the backward emotions still in reversed order."""
    seqs_f, consts_f = rnn_f.gather(U, qmask)
    seqs_b, consts_b = rnn_r.gather(reverse_seq(U, umask), reverse_seq(qmask, umask))
    es, alphas = recurrence(_stack([consts_f, consts_b]), _stack([seqs_f, seqs_b], 1), drop)
    return es[:, 0], es[:, 1], alphas[:, 0], alphas[:, 1]


def cell_dropout(rate: float, generator: torch.Generator | None):
    """The cells' dropout: ``rate`` from ``generator``, the identity
    without one (eval)."""
    return partial(dropout, p=rate, generator=generator) if generator is not None else (
        lambda v: v)


def matching_attention_general2(M, x, mask, transform):
    """The reference's 'general2' ``MatchingAttention`` batched over the
    queries: scores ``transform(x) . M``, softmax of the scores times the
    mask, then masked and renormalised (a zero denominator, a fully padded
    row, is taken as 1 so the row stays finite). M ``[L, B, D]``, x ``[T,
    B, D]``, mask ``[B, L]``; returns the pooled ``[T, B, D]`` and alpha
    ``[T, B, L]``."""
    Mb = M.transpose(0, 1)  # [B, L, D]
    scores = torch.matmul(transform(x).transpose(0, 1), Mb.transpose(1, 2))  # [B, T, L]
    m = mask[:, None, :]
    alpha = torch.softmax(scores * m, dim=2) * m
    denom = alpha.sum(2, keepdim=True)
    alpha = alpha / torch.where(denom > 0, denom, 1.0)
    return torch.matmul(alpha, Mb).transpose(0, 1), alpha.transpose(0, 1)


class BiModel(nn.Module):
    """Bidirectional DialogueRNN. Input U time-major ``[L, B, D_m]``, qmask
    ``[L, B, P]`` (any P), umask ``[B, L]``. Returns ``(log_prob [L, B,
    n_classes], alpha [L, B, L], alpha_f, alpha_b)``: the log-probabilities,
    the pooling attention and each direction's context attentions ``[L, B,
    L]``. Another input width than D_m raises ``ValueError``. In train mode
    every dropout draws from ``generator``, which must be given."""

    def __init__(self, D_m: int = 712, D_g: int = 500, D_p: int = 500, D_e: int = 300,
                 D_h: int = 300, n_classes: int = 6, dropout_rec: float = 0.1,
                 dropout: float = 0.1, *, generator: torch.Generator):
        super().__init__()
        g = generator
        self.D_m = D_m
        self.dropout_rate = dropout_rec  # the cells' four dropouts a step
        self.dialog_rnn_f = DialogueRNN(D_m, D_g, D_p, D_e, generator=g)
        self.dialog_rnn_r = DialogueRNN(D_m, D_g, D_p, D_e, generator=g)
        self.dropout_rec = Dropout(dropout + 0.15)  # on the emotion sequences
        self.dropout = Dropout(dropout)
        self.linear = TorchLinear(2 * D_e, 2 * D_h, generator=g)
        self.smax_fc = TorchLinear(2 * D_h, n_classes, generator=g)
        self.matchatt = MatchingAttention(2 * D_e, 2 * D_e, True, generator=g)

    def forward(self, U, qmask, umask, generator: torch.Generator | None = None):
        if U.shape[-1] != self.D_m:
            raise ValueError(
                f"DialogueRNN takes D_m = {self.D_m} input features a step (the trimodal "
                f"text 100 + audio + visual); got {U.shape[-1]} (MELD's trimodal input is "
                "100 + 300 + 600 = 1000 wide, which the JAX package refuses too)")
        g = train_generator(self, generator)
        es_f, es_b, alpha_f, alpha_b = bidirectional(
            self.dialog_rnn_f, self.dialog_rnn_r, U, qmask, umask,
            cell_dropout(self.dropout_rate, g))
        emotions = torch.cat([self.dropout_rec(es_f, g),
                              self.dropout_rec(reverse_seq(es_b, umask), g)], -1)
        att_emotions, alpha = matching_attention_general2(emotions, emotions, umask,
                                                          self.matchatt.transform)
        hidden = self.dropout(torch.relu(self.linear(att_emotions)), g)
        log_prob = torch.log_softmax(self.smax_fc(hidden), dim=2)
        return log_prob, alpha, alpha_f, alpha_b
