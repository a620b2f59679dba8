"""The MARN1 ablation variants (counterpart of
``ser_tpu/models/marn_variants.py``): sp, cf, azs, sps, nsps and no_en, which
run the per-step rank-1 attention, and mf and la, which do not.

Each variant is a bidirectional dialogue recurrence with its own speaker
memory (an LSTHM on the selected party state for sp, one shared LSTMCell for
cf, azs, mf and la, a per-party LSTMCell pair over compacted rows for sps, a
GRU with a listener pass-through for nsps and no_en), two LSTHM cells per
step and, but for mf and la, the rank-1 cross attention from c_l to c_a,
then a head of its own. mf's cells add a memory-fusion gate from their own
sequence attentions (``lsthm_mf_gates``); la's gate their inputs by the
softmax of two aux LSTMCells' cell states. The reference's quirks are kept
in the math: the sp/cf/azs/mf/la broadcast scatter (the non-speaker slot
takes the selected speaker's previous memory), sps's compaction whose
speaker state is permuted against batch order, the nsps listener ``(1 -
idx) mod P``, sp/cf/azs/mf/la reading the text features' first 200 dims as
x_l and x_a, la's aux LSTMs both reading x_l.

Both directions run as one Python loop over T (``fused_directions``, the
JAX package's ``_fused_directions`` with the direction axis written out), in
eval as in train. Every step of the six rank-1 variants calls the rank-1
attention once for both directions, bound once a call by
``ops.kernels.rank1.bind``: the CUDA kernel on the card (one launch a step
in eval, and one more in the backward in train), the plain version on the
CPU. In eval it is bound at p = 0 with a constant seed (the module's
``rank1_seed`` buffer, not in ``state_dict``); in train the seed and every
dropout mask are drawn from the trainer's ``torch.Generator`` (0.5 on the
cells' h states where the reference has them, 0.2 in the attention). mf's
and la's loops bind nothing and draw nothing: their cells have no dropout.

Parameter names and layouts are the reference's torch ones, so
``state_dict()`` keys equal the JAX package's
``export_state_dict(params, NAME, prefix="")``. Parameters the reference
declares and never uses stay (the S projections where the LSTHM is 3-term,
``lstm_s``, the a2l rank-1 vectors, ``linear``, ``fc2``, cf's
``crossatt_a2l``, no_en's ``encoder_l``, la's encoders, sequence attentions
and V): the forward never touches them, so their ``.grad`` stays None and
Adam skips them.
"""

from __future__ import annotations

from functools import partial

import torch
from torch import nn

from ser_tpu_torch.ops.attention import (CrossAttentionReSeq, CrossAttentionSeq,
                                         CrossAttentionSeqLN, Rank1Weights,
                                         attention_tail)
from ser_tpu_torch.ops.cells import (LSTHM, RNNCellWeights, gru_step, lsthm_gates,
                                     lsthm_mf_gates, lstm_step)
from ser_tpu_torch.ops.encoder import EncoderLayer
from ser_tpu_torch.ops.kernels.rank1 import bind as rank1_bind
from ser_tpu_torch.ops.layers import Dropout, TorchLinear, dropout, train_generator
from ser_tpu_torch.ops.masking import reverse_seq, select_parties
from ser_tpu_torch.utils import profiling

H = 128  # every cell's hidden width
D_R, D_M = 1024, 100  # RoBERTa width, the modality width the cells read


def _state_weights(*linears):
    """``(K, b)`` of a fused state product: the kernels ``[in, out]`` of
    ``linears`` stacked in order, their biases summed in order, as
    ``[1, out]``."""
    b = linears[0].bias
    for lin in linears[1:]:
        b = b + lin.bias
    return torch.cat([lin.weight.T for lin in linears], 0), b[None]


def _broadcast_scatter(sel, new, qmask_t):
    """The sp/cf/azs/sps/nsps party update ``sel * (1 - qmask) + new *
    qmask``, both broadcast over the parties: a non-speaker slot takes
    ``sel`` (for sp the selected speaker's previous memory, not its own).
    sel, new ``[..., D]``, qmask_t ``[..., P]``; returns ``[..., P, D]``."""
    m = qmask_t[..., None]
    return sel[..., None, :] * (1.0 - m) + new[..., None, :] * m


def fused_directions(cell_f, cell_b, inputs_f, inputs_b, step, init,
                     generator, eval_seed, dropout_rate, attn_dropout,
                     attention: bool = True):
    """Both directions of a recurrence as one loop over T.

    ``cell.gather(*inputs) -> (seqs, consts)`` hoists the x-side
    projections over all steps and fuses the state weights; with
    ``attention`` the consts end with the rank-1 wq, wk. Both directions are
    stacked on a leading axis of 2 (seqs ``[T, 2, ...]``, consts ``[2,
    ...]``). ``init(B, P)`` gives the carry's shapes without the direction
    axis; the carry starts at zeros. ``step(consts, carry, xs, t, attend,
    drop) -> (carry, y)`` is one step of both directions. With ``generator``
    (train), ``drop`` is inverted dropout at ``dropout_rate`` and the
    attention drops at ``attn_dropout`` from one int32 seed, both drawn from
    the generator on its device; with None (eval) ``drop`` is the identity
    and the attention is bound at p = 0 with ``eval_seed``. Without
    ``attention`` (mf and la, whose cells hold no dropout either) ``attend``
    is None, ``drop`` the identity, and nothing is drawn. Returns the
    stacked ``y``, ``[T, 2, B, ...]``."""
    seqs_f, consts_f = cell_f.gather(*inputs_f)
    seqs_b, consts_b = cell_b.gather(*inputs_b)
    seqs = [torch.stack([f, b], 1) for f, b in zip(seqs_f, seqs_b)]
    consts = [torch.stack([f, b]) for f, b in zip(consts_f, consts_b)]
    with profiling.annotate("ser#recurrence"):
        attend, drop = None, (lambda x: x)
        if attention:
            *consts, wq, wk = consts
            if generator is None:
                seed, p = eval_seed, 0.0
            else:
                seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                                     device=generator.device, dtype=torch.int32)
                p, drop = attn_dropout, partial(dropout, p=dropout_rate, generator=generator)
            if generator is None:
                # wq, wk, seed, p checked once; the eval recurrence runs the f32
                # form, so under bf16 autocast (the serving artifacts' bf16 and
                # int8) its inputs widen here
                kernel = rank1_bind(wq.float(), wk.float(), seed, p)
                attend = lambda x1, x2, t: kernel(x1.float(), x2.float(), t)  # noqa: E731
            else:
                # a train step's dtype picks the kernel's form: f32, or bf16 in a
                # --compute_dtype bf16 step; nothing widens here
                attend = rank1_bind(wq, wk, seed, p)
        T, _, B = seqs[0].shape[:3]
        P = inputs_f[-1].shape[-1]  # every cell takes qmask last
        carry = tuple(seqs[0].new_zeros((2,) + s) for s in init(B, P))
        ys = []
        for t in range(T):
            carry, y = step(consts, carry, [s[t] for s in seqs], t, attend, drop)
            ys.append(y)
        return torch.stack(ys)


def _sp_step(consts, carry, xs, t, attend, drop):
    """sp: the speaker's LSTHM on [q0, h_q, z], then the l and a LSTHMs on
    [h, z]; y = [h_l | h_a | z | h_q]."""
    K_l, b_l, K_a, b_a, K_q, b_q = consts
    h_l, c_l, h_a, c_a, h_q, c_q, z, q = carry
    xlp, xap, qm = xs
    q0 = select_parties(q, qm)
    c_q, h_q = lsthm_gates(torch.matmul(torch.cat([q0, h_q, z], -1), K_q) + b_q, c_q)
    h_q = drop(h_q)
    q = _broadcast_scatter(q0, h_q, qm)
    c_l, h_l = lsthm_gates(xlp + torch.matmul(torch.cat([h_l, z], -1), K_l) + b_l, c_l)
    h_l = drop(h_l)
    c_a, h_a = lsthm_gates(xap + torch.matmul(torch.cat([h_a, z], -1), K_a) + b_a, c_a)
    h_a = drop(h_a)
    z = attend(c_l, c_a, t)
    return (h_l, c_l, h_a, c_a, h_q, c_q, z, q), torch.cat([h_l, h_a, z, h_q], -1)


def _shared_lstm_step(consts, carry, xs, t, attend, drop, speaker_term, emit_q):
    """cf and azs: one LSTMCell on the selected party state, then the l and
    a LSTHMs on [h, z] (cf) or [h, z, h_s] (azs); no dropout in the cell
    but the attention's. y = [h_l | h_a | z] (azs) or [h_l | h_a | z | h_s]
    (cf)."""
    K_l, b_l, K_a, b_a, sWih, sbih, sWhh, sbhh = consts
    h_l, c_l, h_a, c_a, h_s, c_s, z, q = carry
    xlp, xap, qm = xs
    q0 = select_parties(q, qm)
    h_s, c_s = lstm_step(torch.matmul(q0, sWih) + sbih, h_s, c_s, sWhh, sbhh)
    q = _broadcast_scatter(q0, h_s, qm)
    extra = [h_s] if speaker_term else []
    c_l, h_l = lsthm_gates(
        xlp + torch.matmul(torch.cat([h_l, z, *extra], -1), K_l) + b_l, c_l)
    c_a, h_a = lsthm_gates(
        xap + torch.matmul(torch.cat([h_a, z, *extra], -1), K_a) + b_a, c_a)
    z = attend(c_l, c_a, t)
    y = torch.cat([h_l, h_a, z, h_s] if emit_q else [h_l, h_a, z], -1)
    return (h_l, c_l, h_a, c_a, h_s, c_s, z, q), y


def sps_orders(qmask):
    """sps's compaction indices for all steps (they depend on qmask alone):
    ``(order0, order1, n0, n1)``, each party's rows first in batch order by
    a stable argsort over B, and the party's row count. Rows of parties >= 2
    are in neither compaction (the reference's ``_select_parties`` has no
    branch for them); an all-zero (padded) row counts as party 0, as
    ``argmax`` takes it. qmask ``[..., B, P]``."""
    idx = qmask.argmax(-1)
    is0, is1 = idx == 0, idx == 1
    order0 = torch.argsort((~is0).to(torch.int32), dim=-1, stable=True)
    order1 = torch.argsort((~is1).to(torch.int32), dim=-1, stable=True)
    return order0, order1, is0.sum(-1), is1.sum(-1)


def _sps_step(consts, carry, xs, t, attend, drop):
    """sps: each party's rows compacted to the front of a zero-padded
    buffer, the two party LSTMCells as one batched step (a party with no
    rows keeps its carry), then ``h_q = cat(h_q0[:n0], h_q1[:n1])``: the
    speaker state the LSTHMs read is permuted against batch order, as the
    reference trained it. The party carry is ``[2 (direction), 2 (party),
    B, H]``. y = [h_l | h_a | z | h_q]."""
    K_l, b_l, K_a, b_a, qWih, qbih, qWhh, qbhh = consts
    h_l, c_l, h_a, c_a, h_qp, c_qp, z, q = carry
    xlp, xap, qm, order0, order1, n0, n1 = xs
    B, D = q.shape[1], q.shape[-1]
    slots = torch.arange(B, device=q.device)
    take = lambda v, idx: torch.gather(v, 1, idx[..., None].expand(-1, -1, D))  # noqa: E731
    n = torch.stack([n0, n1], 1)  # [2, 2] (direction, party)
    q_sel = torch.stack([take(q[:, :, 0], order0), take(q[:, :, 1], order1)], 1)
    q_sel = q_sel * (slots < n[..., None])[..., None].to(q.dtype)
    nh, nc = lstm_step(torch.matmul(q_sel, qWih) + qbih, h_qp, c_qp, qWhh, qbhh)
    nh = drop(nh)
    alive = (n > 0)[..., None, None]
    h_qp, c_qp = torch.where(alive, nh, h_qp), torch.where(alive, nc, c_qp)
    take0 = (slots < n0[:, None])[..., None]
    from1 = (slots - n0[:, None]).clamp(0, B - 1)
    h_q = torch.where(take0, h_qp[:, 0], take(h_qp[:, 1], from1))
    h_0 = torch.where(take0, q_sel[:, 0], take(q_sel[:, 1], from1))
    q = _broadcast_scatter(h_0, h_q, qm)
    c_l, h_l = lsthm_gates(xlp + torch.matmul(torch.cat([h_l, z, h_q], -1), K_l) + b_l, c_l)
    h_l = drop(h_l)
    c_a, h_a = lsthm_gates(xap + torch.matmul(torch.cat([h_a, z, h_q], -1), K_a) + b_a, c_a)
    h_a = drop(h_a)
    z = attend(c_l, c_a, t)
    return (h_l, c_l, h_a, c_a, h_qp, c_qp, z, q), torch.cat([h_l, h_a, z, h_q], -1)


def listener(q, qmask_t):
    """nsps's listener memory, party ``(1 - argmax(qmask)) mod P``: the
    reference's ``q[1 - idx]`` wraps a negative index, so at P = 9 speaker 2
    reads party 8 (and a padded row, party 0's, reads party 1). q
    ``[..., P, D]``, qmask_t ``[..., P]``; returns ``[..., D]``."""
    P = q.shape[-2]
    other = torch.remainder(1 - qmask_t.argmax(-1), P)
    onehot = (other[..., None] == torch.arange(P, device=q.device)).to(q.dtype)
    return torch.einsum("...p,...pd->...d", onehot, q)


def _nsps_step(consts, carry, xs, t, attend, drop):
    """nsps and no_en: a GRU on the speaker's memory with the 200-d input,
    the listener's memory passed through to the non-speaker slots, then the
    l and a LSTHMs on [h, z, h_s]; y = [h_l | h_a]."""
    K_l, b_l, K_a, b_a, gWhh, gbhh = consts
    h_l, c_l, h_a, c_a, z, q = carry
    xlp, xap, gxp, qm = xs
    h_s = drop(gru_step(gxp, select_parties(q, qm), gWhh, gbhh))
    q = _broadcast_scatter(listener(q, qm), h_s, qm)
    c_l, h_l = lsthm_gates(xlp + torch.matmul(torch.cat([h_l, z, h_s], -1), K_l) + b_l, c_l)
    h_l = drop(h_l)
    c_a, h_a = lsthm_gates(xap + torch.matmul(torch.cat([h_a, z, h_s], -1), K_a) + b_a, c_a)
    h_a = drop(h_a)
    z = attend(c_l, c_a, t)
    return (h_l, c_l, h_a, c_a, z, q), torch.cat([h_l, h_a], -1)


def _mf_step(consts, carry, xs, t, attend, drop):
    """mf: the shared LSTMCell on the selected party state, then the l and a
    LSTHMs on [h, h_s] with the memory-fusion gate ``sigmoid(V x_la)`` (its
    pre-activation hoisted over all steps); y = [h_l | h_a]."""
    K_l, b_l, K_a, b_a, sWih, sbih, sWhh, sbhh = consts
    h_l, c_l, h_a, c_a, h_s, c_s, q = carry
    xlp, xap, zgl, zga, qm = xs
    q0 = select_parties(q, qm)
    h_s, c_s = lstm_step(torch.matmul(q0, sWih) + sbih, h_s, c_s, sWhh, sbhh)
    q = _broadcast_scatter(q0, h_s, qm)
    c_l, h_l = lsthm_mf_gates(xlp + torch.matmul(torch.cat([h_l, h_s], -1), K_l) + b_l,
                              zgl, c_l)
    c_a, h_a = lsthm_mf_gates(xap + torch.matmul(torch.cat([h_a, h_s], -1), K_a) + b_a,
                              zga, c_a)
    return (h_l, c_l, h_a, c_a, h_s, c_s, q), torch.cat([h_l, h_a], -1)


def _la_step(consts, carry, xs, t, attend, drop):
    """la: the shared LSTMCell as mf's, two aux LSTMCells on x_l (the
    reference feeds x_l to both), the inputs gated by the softmax of their
    cell states, then the l and a LSTHMs on [gated x, h, h_s] in one product
    each; y = [h_l | h_a]."""
    (K_l, b_l, K_a, b_a, sWih, sbih, sWhh, sbhh,
     glWhh, glbhh, gaWhh, gabhh) = consts
    h_l, c_l, h_a, c_a, h_s, c_s, hgl, cgl, hga, cga, q = carry
    x_l, x_a, glp, gap, qm = xs
    q0 = select_parties(q, qm)
    h_s, c_s = lstm_step(torch.matmul(q0, sWih) + sbih, h_s, c_s, sWhh, sbhh)
    q = _broadcast_scatter(q0, h_s, qm)
    hgl, cgl = lstm_step(glp, hgl, cgl, glWhh, glbhh)
    hga, cga = lstm_step(gap, hga, cga, gaWhh, gabhh)
    in_l = torch.softmax(cgl, -1) * x_l
    in_a = torch.softmax(cga, -1) * x_a
    c_l, h_l = lsthm_gates(torch.matmul(torch.cat([in_l, h_l, h_s], -1), K_l) + b_l, c_l)
    c_a, h_a = lsthm_gates(torch.matmul(torch.cat([in_a, h_a, h_s], -1), K_a) + b_a, c_a)
    return ((h_l, c_l, h_a, c_a, h_s, c_s, hgl, cgl, hga, cga, q),
            torch.cat([h_l, h_a], -1))


class _Cell(nn.Module):
    """What every variant's cell declares: the l and a LSTHMs
    (``LSTHM(d_in, H, H, H)``) and the rank-1 vectors (l2a's Wq, Wk used;
    its Wv and all of a2l unused)."""

    def __init__(self, d_in: int, *, generator: torch.Generator):
        super().__init__()
        self.lsthm_l = LSTHM(d_in, H, H, H, generator=generator)
        self.lsthm_a = LSTHM(d_in, H, H, H, generator=generator)
        self.crossatt_l2a = Rank1Weights(H)
        self.crossatt_a2l = Rank1Weights(H)

    def rank1(self):
        return self.crossatt_l2a.Wq[0], self.crossatt_l2a.Wk[0]

    def state_weights(self, speaker_term: bool):
        """``(K_l, b_l, K_a, b_a)`` over [h, z] or [h, z, s]."""
        l, a = self.lsthm_l, self.lsthm_a
        extra_l, extra_a = ((l.S,), (a.S,)) if speaker_term else ((), ())
        return (*_state_weights(l.U, l.V, *extra_l), *_state_weights(a.U, a.V, *extra_a))


class MARNCellSP(_Cell):
    """sp (ref ``lsthm_sp.py``): the speaker memory by a 3-term LSTHM on the
    selected party state. S and ``lstm_s`` declared, unused."""

    def __init__(self, *, generator: torch.Generator):
        super().__init__(D_M, generator=generator)
        self.lsthm_q = LSTHM(H, H, H, H, generator=generator)
        self.lstm_s = RNNCellWeights(H, H, 4, generator=generator)

    def gather(self, x_l, x_a, qmask):
        q = self.lsthm_q
        return ((self.lsthm_l.W(x_l), self.lsthm_a.W(x_a), qmask),
                (*self.state_weights(False), *_state_weights(q.W, q.U, q.V),
                 *self.rank1()))


class MARNCellSharedLSTM(_Cell):
    """cf and azs (ref ``lsthm_cf.py``, ``lsthm_azs.py``): the speaker memory
    by one shared LSTMCell ``lstm_s``; azs also holds its encoders (d_inner
    50) and runs them on its direction's own input."""

    def __init__(self, with_encoders: bool, *, generator: torch.Generator,
                 encoder_attention: str = "mha"):
        super().__init__(D_M, generator=generator)
        self.lstm_s = RNNCellWeights(H, H, 4, generator=generator)
        self.speaker_term = with_encoders  # azs's LSTHMs are 4-term
        if with_encoders:
            self.encoder_l = EncoderLayer(D_M, 50, 8, 40, 40, generator=generator,
                                          attention=encoder_attention)
            self.encoder_a = EncoderLayer(D_M, 50, 8, 40, 40, generator=generator,
                                          attention=encoder_attention)

    def encode(self, x, generator=None):
        """azs: time-major ``(x_l, x_a)`` of x's first 200 dims, encoded."""
        enc = lambda e, xx: e(xx.transpose(0, 1), generator).transpose(0, 1)  # noqa: E731
        return enc(self.encoder_l, x[:, :, :D_M]), enc(self.encoder_a, x[:, :, D_M:2 * D_M])

    def gather(self, x_l, x_a, qmask):
        s = self.lstm_s
        return ((self.lsthm_l.W(x_l), self.lsthm_a.W(x_a), qmask),
                (*self.state_weights(self.speaker_term), s.weight_ih.T, s.bias_ih[None],
                 s.weight_hh.T, s.bias_hh[None], *self.rank1()))


class MARNCellSPS(_Cell):
    """sps (ref ``lsthm_sps.py``): a 4-term LSTHM and one LSTMCell a party
    (``lstm_q0``, ``lstm_q1``) over that party's compacted rows. ``lstm_s``
    declared, unused."""

    def __init__(self, *, generator: torch.Generator):
        super().__init__(D_M, generator=generator)
        self.lstm_q0 = RNNCellWeights(H, H, 4, generator=generator)
        self.lstm_q1 = RNNCellWeights(H, H, 4, generator=generator)
        self.lstm_s = RNNCellWeights(H, H, 4, generator=generator)

    def gather(self, x_l, x_a, qmask):
        q0, q1 = self.lstm_q0, self.lstm_q1
        pair = lambda a, b: torch.stack([a, b])  # noqa: E731  # [party, ...]
        return ((self.lsthm_l.W(x_l), self.lsthm_a.W(x_a), qmask, *sps_orders(qmask)),
                (*self.state_weights(True),
                 pair(q0.weight_ih.T, q1.weight_ih.T), pair(q0.bias_ih, q1.bias_ih)[:, None],
                 pair(q0.weight_hh.T, q1.weight_hh.T), pair(q0.bias_hh, q1.bias_hh)[:, None],
                 *self.rank1()))


class MARNCellNSPS(_Cell):
    """nsps and no_en (ref ``lsthm_nsps.py``): a 4-term LSTHM and the GRU
    ``gru_s`` on the 200-d [x_l | x_a] before the encoders. ``gru_l``
    declared, unused."""

    def __init__(self, *, generator: torch.Generator):
        super().__init__(D_M, generator=generator)
        self.gru_s = RNNCellWeights(2 * D_M, H, 3, generator=generator)
        self.gru_l = RNNCellWeights(2 * D_M, H, 3, generator=generator)

    def gather(self, x, x_l, x_a, qmask):
        g = self.gru_s
        return ((self.lsthm_l.W(x_l), self.lsthm_a.W(x_a),
                 torch.matmul(x, g.weight_ih.T) + g.bias_ih, qmask),
                (*self.state_weights(True), g.weight_hh.T, g.bias_hh[None],
                 *self.rank1()))


class _CellNoAttn(nn.Module):
    """What mf's and la's cells declare (ref ``lsthm_mf.py``,
    ``lsthm_la.py``): the l and a LSTHMs with an ``[H, H]`` V, the shared
    speaker LSTMCell ``lstm_s``, the encoders (d_inner 50) and the two
    sequence cross attentions, all inside the cell."""

    def __init__(self, *, generator: torch.Generator, encoder_attention: str = "mha"):
        super().__init__()
        g = generator
        self.lsthm_l = LSTHM(D_M, H, H, H, generator=g, v_out=H)
        self.lsthm_a = LSTHM(D_M, H, H, H, generator=g, v_out=H)
        self.lstm_s = RNNCellWeights(H, H, 4, generator=g)
        self.encoder_l = EncoderLayer(D_M, 50, 8, 40, 40, generator=g, attention=encoder_attention)
        self.encoder_a = EncoderLayer(D_M, 50, 8, 40, 40, generator=g, attention=encoder_attention)
        self.crossatt_l2a = CrossAttentionSeq()
        self.crossatt_a2l = CrossAttentionSeq()

    def speaker_weights(self):
        s = self.lstm_s
        return s.weight_ih.T, s.bias_ih[None], s.weight_hh.T, s.bias_hh[None]


class MARNCellMF(_CellNoAttn):
    """mf (ref ``lsthm_mf.py:78-156``): each encoder once, on this
    direction's own input (the backward cell encodes the reversed x); the
    sequence attentions' outputs feed V, the memory-fusion gate of
    ``lsthm_mf_gates``; 3-term LSTHMs on [h, h_s]."""

    def encode(self, x, generator=None):
        """``(x_l, x_a, x_la, x_al)``, time-major, from x's first 200 dims."""
        enc = lambda e, xx: e(xx.transpose(0, 1), generator).transpose(0, 1)  # noqa: E731
        x_l = enc(self.encoder_l, x[:, :, :D_M])
        x_a = enc(self.encoder_a, x[:, :, D_M:2 * D_M])
        return (x_l, x_a, self.crossatt_l2a(x_l, x_a, generator),
                self.crossatt_a2l(x_a, x_l, generator))

    def gather(self, x_l, x_a, x_la, x_al, qmask):
        l, a = self.lsthm_l, self.lsthm_a
        return ((l.W(x_l), a.W(x_a), l.V(x_la), a.V(x_al), qmask),
                (*_state_weights(l.U, l.S), *_state_weights(a.U, a.S),
                 *self.speaker_weights()))


class MARNCellLA(_CellNoAttn):
    """la (ref ``lsthm_la.py:76-165``): no z; the raw x_l and x_a gated by
    the aux LSTMCells ``lstm_la_l`` and ``lstm_la_a`` (both read x_l), W, U
    and S in one product. The encoders, the sequence attentions and V are
    declared and never applied."""

    def __init__(self, *, generator: torch.Generator, encoder_attention: str = "mha"):
        super().__init__(generator=generator, encoder_attention=encoder_attention)
        self.lstm_la_l = RNNCellWeights(D_M, D_M, 4, generator=generator)
        self.lstm_la_a = RNNCellWeights(D_M, D_M, 4, generator=generator)

    def gather(self, x_l, x_a, qmask):
        l, a, gl, ga = self.lsthm_l, self.lsthm_a, self.lstm_la_l, self.lstm_la_a
        aux = lambda rnn: torch.matmul(x_l, rnn.weight_ih.T) + rnn.bias_ih  # noqa: E731
        return ((x_l, x_a, aux(gl), aux(ga), qmask),
                (*_state_weights(l.W, l.U, l.S), *_state_weights(a.W, a.U, a.S),
                 *self.speaker_weights(), gl.weight_hh.T, gl.bias_hh[None],
                 ga.weight_hh.T, ga.bias_hh[None]))


def _log_probs(nn_out, feats, generator):
    """The head ``Linear -> ReLU -> Dropout -> Linear -> log_softmax``,
    time-major ``[L, B, d]`` in, ``[B*L, C]`` out."""
    head, relu, drop, out = nn_out
    logp = torch.log_softmax(out(drop(relu(head(feats)), generator)), dim=2)
    return logp.transpose(0, 1).reshape(-1, logp.shape[-1])


def _head(d_in: int, n_classes: int, generator):
    # index 2 is the reference's Dropout(0.5) (nn_out_drop)
    return nn.Sequential(TorchLinear(d_in, 32, generator=generator), nn.ReLU(),
                         Dropout(0.5), TorchLinear(32, n_classes, generator=generator))


class _Variant(nn.Module):
    """What the models share: the recurrence's rates and the eval seed of
    the rank-1 attention. Input x is time-major ``[L, B, 1024 + d_audio]``
    (1124 for IEMOCAP, 1324 for MELD), qmask ``[L, B, P]``, umask ``[B,
    L]``; the first output is the log-probabilities ``[B*L, n_classes]``."""

    dropout_rate = 0.5  # the cells' h states, where the reference has them
    attn_dropout = 0.2  # the per-step rank-1 attention
    rank1 = True  # the cells' consts end with the rank-1 wq, wk
    # the train forward makes no host sync: a CUDA graph can hold the step
    train_graph_safe = True

    def __init__(self, n_classes: int):
        super().__init__()
        self.n_classes = n_classes
        if self.rank1:
            self.register_buffer("rank1_seed", torch.zeros(1, dtype=torch.int32),
                                 persistent=False)

    def _recurrence(self, inputs_f, inputs_b, step, init, generator):
        return fused_directions(self.marn_cell_f, self.marn_cell_b, inputs_f, inputs_b,
                                step, init, generator, getattr(self, "rank1_seed", None),
                                self.dropout_rate, self.attn_dropout, self.rank1)

    def _bidir(self, ys, umask, generator):
        """``[y_f | y_b]`` with y_b back in time order, each through its
        ``Dropout(0.5)``."""
        return torch.cat([self.dropout_rec(ys[:, 0], generator),
                          self.dropout_rec_b(reverse_seq(ys[:, 1], umask), generator)], -1)


def _reversed(umask, *xs):
    return tuple(reverse_seq(x, umask) for x in xs)


def _carry(n_states):
    """``init`` for ``fused_directions``: ``n_states`` [B, H] states and the
    party memory [B, P, H]."""
    return lambda B, P: [(B, H)] * n_states + [(B, P, H)]


class MARN1SP(_Variant):
    """MARN1_sp (ref ``lsthm_sp.py:226-310``): one encoder pass a modality on
    x_l = x[..., :100], x_a = x[..., 100:200] (both text), the sp recurrence,
    the two sequence attentions, the head on 1280. Returns ``(log_probs,
    x_l, x_a)``."""

    def __init__(self, n_classes: int = 6, *, generator: torch.Generator,
                 encoder_attention: str = "mha"):
        super().__init__(n_classes)
        g = generator
        self.encoder_l = EncoderLayer(D_M, 40, 8, 40, 40, generator=g, attention=encoder_attention)
        self.encoder_a = EncoderLayer(D_M, 40, 8, 40, 40, generator=g, attention=encoder_attention)
        self.marn_cell_f = MARNCellSP(generator=g)
        self.marn_cell_b = MARNCellSP(generator=g)
        self.dropout_rec, self.dropout_rec_b = Dropout(0.5), Dropout(0.5)
        self.crossatt_l2a = CrossAttentionSeq()
        self.crossatt_a2l = CrossAttentionSeq()
        d_feat = 2 * 4 * H + 2 * H
        self.nn_out = _head(d_feat, n_classes, g)
        self.linear = TorchLinear(d_feat, 32, generator=g)  # unused

    def forward(self, x, qmask, umask, generator: torch.Generator | None = None):
        g = train_generator(self, generator)
        enc = lambda e, xx: e(xx.transpose(0, 1), g).transpose(0, 1)  # noqa: E731
        x_l = enc(self.encoder_l, x[:, :, :D_M])
        x_a = enc(self.encoder_a, x[:, :, D_M:2 * D_M])
        ys = self._recurrence((x_l, x_a, qmask), _reversed(umask, x_l, x_a, qmask),
                              _sp_step, _carry(7), g)
        attn1 = self.crossatt_l2a(x_l, x_a, g)
        attn2 = self.crossatt_a2l(x_a, x_l, g)
        feats = torch.cat([self._bidir(ys, umask, g), attn1, attn2], -1)
        return _log_probs(self.nn_out, feats, g), x_l, x_a


class MARN1CF(_Variant):
    """MARN1_cf (ref ``lsthm_cf.py:206-290``): as sp's input and encoders,
    the shared-LSTMCell recurrence with a 3-term LSTHM and h_s in its
    output, one sequence attention (l2a; a2l declared, unused), the head on
    1152. Returns ``(log_probs, x_l, x_a)``."""

    def __init__(self, n_classes: int = 6, *, generator: torch.Generator,
                 encoder_attention: str = "mha"):
        super().__init__(n_classes)
        g = generator
        self.encoder_l = EncoderLayer(D_M, 40, 8, 40, 40, generator=g, attention=encoder_attention)
        self.encoder_a = EncoderLayer(D_M, 40, 8, 40, 40, generator=g, attention=encoder_attention)
        self.marn_cell_f = MARNCellSharedLSTM(False, generator=g)
        self.marn_cell_b = MARNCellSharedLSTM(False, generator=g)
        self.dropout_rec, self.dropout_rec_b = Dropout(0.5), Dropout(0.5)
        self.crossatt_l2a = CrossAttentionSeq()
        self.crossatt_a2l = CrossAttentionSeq()  # unused
        d_feat = 2 * 4 * H + H
        self.nn_out = _head(d_feat, n_classes, g)
        self.linear = TorchLinear(d_feat, 32, generator=g)  # unused

    def forward(self, x, qmask, umask, generator: torch.Generator | None = None):
        g = train_generator(self, generator)
        enc = lambda e, xx: e(xx.transpose(0, 1), g).transpose(0, 1)  # noqa: E731
        x_l = enc(self.encoder_l, x[:, :, :D_M])
        x_a = enc(self.encoder_a, x[:, :, D_M:2 * D_M])
        step = partial(_shared_lstm_step, speaker_term=False, emit_q=True)
        ys = self._recurrence((x_l, x_a, qmask), _reversed(umask, x_l, x_a, qmask),
                              step, _carry(7), g)
        feats = torch.cat([self._bidir(ys, umask, g), self.crossatt_l2a(x_l, x_a, g)], -1)
        return _log_probs(self.nn_out, feats, g), x_l, x_a


class MARN1AZS(_Variant):
    """MARN1_azs (ref ``lsthm_azs.py:155-218``): each direction's cell
    encodes its own input (the backward one the reversed x), the
    shared-LSTMCell recurrence with a 4-term LSTHM, no sequence attention,
    the head on 768. Returns ``(log_probs,)``."""

    def __init__(self, n_classes: int = 6, *, generator: torch.Generator,
                 encoder_attention: str = "mha"):
        super().__init__(n_classes)
        g = generator
        self.marn_cell_f = MARNCellSharedLSTM(True, generator=g,
                                              encoder_attention=encoder_attention)
        self.marn_cell_b = MARNCellSharedLSTM(True, generator=g,
                                              encoder_attention=encoder_attention)
        self.dropout_rec, self.dropout_rec_b = Dropout(0.5), Dropout(0.5)
        d_feat = 2 * 3 * H
        self.nn_out = _head(d_feat, n_classes, g)
        self.linear = TorchLinear(d_feat, 32, generator=g)  # unused

    def forward(self, x, qmask, umask, generator: torch.Generator | None = None):
        g = train_generator(self, generator)
        rev_x, rev_qmask = _reversed(umask, x, qmask)
        step = partial(_shared_lstm_step, speaker_term=True, emit_q=False)
        ys = self._recurrence((*self.marn_cell_f.encode(x, g), qmask),
                              (*self.marn_cell_b.encode(rev_x, g), rev_qmask),
                              step, _carry(7), g)
        return (_log_probs(self.nn_out, self._bidir(ys, umask, g), g),)


class MARN1SPS(_Variant):
    """MARN1_sps (ref ``lsthm_sps.py:298-409``): ``linear_in`` 1024 -> 100 on
    the text, residual-stacked encoders ``enc(x + enc(x))``, the sps
    recurrence, onlysp's attention tail with w, v, v1, v2, and a residual
    head ``nn_out(fc(feats) + x_l + x_a)``. Returns ``(log_probs, x_l,
    x_a)``."""

    def __init__(self, n_classes: int = 6, *, generator: torch.Generator,
                 encoder_attention: str = "mha"):
        super().__init__(n_classes)
        g = generator
        self.linear_in = TorchLinear(D_R, D_M, generator=g)
        self.encoder_l = EncoderLayer(D_M, 40, 8, 40, 40, generator=g, attention=encoder_attention)
        self.encoder_a = EncoderLayer(D_M, 40, 8, 40, 40, generator=g, attention=encoder_attention)
        self.marn_cell_f = MARNCellSPS(generator=g)
        self.marn_cell_b = MARNCellSPS(generator=g)
        self.dropout_rec, self.dropout_rec_b = Dropout(0.5), Dropout(0.5)
        for name in ("w", "v", "v1", "v2"):
            self.register_parameter(name, nn.Parameter(torch.ones(1)))
        self.crossatt_l2a = CrossAttentionSeq()
        self.crossatt_a2l = CrossAttentionSeq()
        self.crossatt_l2a_1 = CrossAttentionReSeq()
        self.crossatt_a2l_1 = CrossAttentionReSeq()
        # index 2 is the reference's Dropout(0.5) (fc_drop)
        self.fc = nn.Sequential(TorchLinear(2 * 4 * H + 2 * H, D_M, generator=g),
                                nn.ReLU(), Dropout(0.5))
        self.nn_out = _head(D_M, n_classes, g)

    def forward(self, x, qmask, umask, generator: torch.Generator | None = None):
        g = train_generator(self, generator)
        x_l = self.linear_in(x[:, :, :D_R].transpose(0, 1))  # [B, L, 100]
        x_a = x[:, :, D_R:D_R + D_M].transpose(0, 1)
        x_l = self.encoder_l(x_l + self.encoder_l(x_l, g), g).transpose(0, 1)
        x_a = self.encoder_a(x_a + self.encoder_a(x_a, g), g).transpose(0, 1)
        ys = self._recurrence((x_l, x_a, qmask), _reversed(umask, x_l, x_a, qmask),
                              _sps_step, lambda B, P: [(B, H)] * 4 + [(2, B, H)] * 2
                              + [(B, H), (B, P, H)], g)
        attn1, attn2 = attention_tail(
            (self.crossatt_l2a, self.crossatt_a2l),
            (self.crossatt_l2a_1, self.crossatt_a2l_1),
            self.w * x_l, self.v * x_a, self.v1, self.v2, g)
        lin, relu, drop = self.fc
        out = drop(relu(lin(torch.cat([self._bidir(ys, umask, g), attn1, attn2], -1))), g)
        return _log_probs(self.nn_out, out + x_l + x_a, g), x_l, x_a


class MARN1NSPS(_Variant):
    """MARN1_nsps and, with ``use_text_encoder=False``, MARN1_no_en (ref
    ``lsthm_nsps.py:242-375``, ``lsthm_no_en.py``): ``linear_in`` on the
    text, residual-stacked encoders (no_en bypasses the text one, whose
    parameters stay), the nsps recurrence, two ``CrossAttentionSeqLN``, the
    halves weighted by ``softmax(p)``, a residual ``fc(x_l)`` (``fc2``
    declared, unused) and the head on 712. Returns ``(log_probs, x_l,
    x_a)``."""

    def __init__(self, n_classes: int = 6, use_text_encoder: bool = True, *,
                 generator: torch.Generator, encoder_attention: str = "mha"):
        super().__init__(n_classes)
        g = generator
        self.use_text_encoder = use_text_encoder
        self.linear_in = TorchLinear(D_R, D_M, generator=g)
        self.encoder_l = EncoderLayer(D_M, 40, 8, 40, 40, generator=g, attention=encoder_attention)
        self.encoder_a = EncoderLayer(D_M, 40, 8, 40, 40, generator=g, attention=encoder_attention)
        self.marn_cell_f = MARNCellNSPS(generator=g)
        self.marn_cell_b = MARNCellNSPS(generator=g)
        self.dropout_rec = Dropout(0.5)
        self.crossatt_l2a = CrossAttentionSeqLN(D_M, D_M, D_M)
        self.crossatt_a2l = CrossAttentionSeqLN(D_M, D_M, D_M)
        self.p = nn.Parameter(torch.ones(2))
        d_feat = 2 * (2 * H + D_M)
        # index 2 is the reference's Dropout(0.5) (fc_drop)
        self.fc = nn.Sequential(TorchLinear(D_M, d_feat, generator=g), nn.ReLU(),
                                Dropout(0.5))
        self.fc2 = nn.Sequential(TorchLinear(D_M, d_feat, generator=g))  # unused
        self.nn_out = _head(d_feat, n_classes, g)

    def forward(self, x, qmask, umask, generator: torch.Generator | None = None):
        g = train_generator(self, generator)
        x_l = self.linear_in(x[:, :, :D_R].transpose(0, 1))  # [B, L, 100]
        x_a = x[:, :, D_R:D_R + D_M].transpose(0, 1)
        xcat = torch.cat([x_l, x_a], 2).transpose(0, 1)  # [L, B, 200], before the encoders
        if self.use_text_encoder:
            x_l = self.encoder_l(x_l + self.encoder_l(x_l, g), g)
        x_a = self.encoder_a(x_a + self.encoder_a(x_a, g), g)
        x_l, x_a = x_l.transpose(0, 1), x_a.transpose(0, 1)
        ys = self._recurrence((xcat, x_l, x_a, qmask),
                              _reversed(umask, xcat, x_l, x_a, qmask),
                              _nsps_step, _carry(5), g)  # [L, 2, B, 2H]
        h_f = self.dropout_rec(ys[:, 0], g)
        h_b = self.dropout_rec(reverse_seq(ys[:, 1], umask), g)
        h_l = torch.cat([h_f[..., :H], h_b[..., :H]], -1)
        h_a = torch.cat([h_f[..., H:], h_b[..., H:]], -1)
        attn1 = self.crossatt_l2a(x_l, x_a, g)
        attn2 = self.crossatt_a2l(x_a, x_l, g)
        pw = torch.softmax(self.p, 0)
        lin, relu, drop = self.fc
        resid_l = drop(relu(lin(x_l)), g)
        feats = torch.cat([pw[0] * torch.cat([h_l, attn2], -1),
                           pw[1] * torch.cat([h_a, attn1], -1)], -1)
        return _log_probs(self.nn_out, feats + resid_l, g), x_l, x_a


class _NoAttnBidir(_Variant):
    """MARN1_mf and MARN1_la (ref ``lsthm_mf.py:158-220``,
    ``lsthm_la.py:166-228``; the JAX package's ``_NoAttnBidir``): the cells
    over x's first 200 dims in both directions (the backward one reversed),
    no rank-1 attention and no dropout in the loop, ``[y_f | y_b]`` through
    ``dropout_rec`` and ``dropout_rec_b``, the head on 512 (``linear``
    declared, unused). Returns ``(log_probs,)``."""

    rank1 = False

    def __init__(self, cell, n_classes: int, generator: torch.Generator,
                 encoder_attention: str = "mha"):
        super().__init__(n_classes)
        g = generator
        self.marn_cell_f = cell(generator=g, encoder_attention=encoder_attention)
        self.marn_cell_b = cell(generator=g, encoder_attention=encoder_attention)
        self.dropout_rec, self.dropout_rec_b = Dropout(0.5), Dropout(0.5)
        self.nn_out = _head(4 * H, n_classes, g)
        self.linear = TorchLinear(4 * H, 32, generator=g)  # unused

    def forward(self, x, qmask, umask, generator: torch.Generator | None = None):
        g = train_generator(self, generator)
        x = x[:, :, :2 * D_M]  # all the cells read
        rev_x, rev_qmask = _reversed(umask, x, qmask)
        ys = self._recurrence((*self._inputs(self.marn_cell_f, x, g), qmask),
                              (*self._inputs(self.marn_cell_b, rev_x, g), rev_qmask),
                              self.step, self.carry, g)
        return (_log_probs(self.nn_out, self._bidir(ys, umask, g), g),)


class MARN1MF(_NoAttnBidir):
    """MARN1_mf: ``MARNCellMF`` in both directions."""

    step = staticmethod(_mf_step)
    carry = staticmethod(_carry(6))

    def __init__(self, n_classes: int = 6, *, generator: torch.Generator,
                 encoder_attention: str = "mha"):
        super().__init__(MARNCellMF, n_classes, generator, encoder_attention)

    def _inputs(self, cell, x, generator):
        return cell.encode(x, generator)


class MARN1LA(_NoAttnBidir):
    """MARN1_la: ``MARNCellLA`` in both directions; the carry holds four
    100-wide aux LSTM states beside the six 128-wide ones."""

    step = staticmethod(_la_step)
    carry = staticmethod(lambda B, P: [(B, H)] * 6 + [(B, D_M)] * 4 + [(B, P, H)])

    def __init__(self, n_classes: int = 6, *, generator: torch.Generator,
                 encoder_attention: str = "mha"):
        super().__init__(MARNCellLA, n_classes, generator, encoder_attention)

    def _inputs(self, cell, x, generator):
        return x[:, :, :D_M], x[:, :, D_M:]
