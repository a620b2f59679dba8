"""MARN1_newz, the unidirectional MARN-style multi-attention z update
(counterpart of ``ser_tpu/models/marn_newz.py``; ref ``lsthm_newz.py``).

Two encoders (d_inner 50) on x_l = x[..., :100] and x_a = x[..., 100:200],
then one forward recurrence: per step a plain Linear ``S`` updates the
selected party's 512-wide speaker memory (the sp-style broadcast scatter),
two 4-term LSTHM1 cells read [h, z (256), S's output (512)], and z is a
softmax(w)-weighted blend of its last value and a multi-attention reduce
over the new cell states (``att``, ``att_l``, ``att_a``, then
``att_cross_modal`` and ``fc_z``), with dropout 0.3 after ``att_l``, ``att_a``
and ``att_cross_modal`` in train. The head emits RAW logits (no
log_softmax), rows batch-major ``[B*L, C]``; the model returns ``(logits,
x_a, x_l)``. ``umask`` is not read: there is no reversed direction.

``causal_encoder=True`` gives both encoders a lower-triangular mask, so
utterance t's encoding sees utterances 0..t only: the batch form of the
streaming path (``ser_tpu_torch/streaming.py``), with the same parameters.

The step is the JAX package's unstacked ``step``, with each cell's U, V and
S fused into one product. ``newz_step`` is shared by the batch loop
(``recurrence``, a Python loop over T on the card) and the stream.
Parameters the reference declares and never uses stay for the keys
(``encoder_v``, ``fc``, ``g_attention.trans``); their ``.grad`` stays None.
"""

from __future__ import annotations

from functools import partial

import torch
from torch import nn

from ser_tpu_torch.ops.cells import LSTHM, lsthm_gates
from ser_tpu_torch.ops.encoder import EncoderLayer
from ser_tpu_torch.ops.layers import Dropout, TorchLinear, dropout, train_generator
from ser_tpu_torch.ops.masking import select_parties

H = 128  # each cell's hidden width
D = 2 * H  # z, and the concatenated cell states
SPEAKER = 4 * H  # the speaker memory
REDUCE = 16 + 128  # att_cross_modal's width
K = 4  # attentions
D_M = 100  # the modality width the encoders read


def _multi_att(proj, cs, width):
    """``softmax`` over each of the K heads of ``proj`` times the cell
    states: ``[B, K, width]``."""
    heads = proj.reshape(proj.shape[0], K, width)
    return torch.softmax(heads, -1) * cs[:, None, :]


def _unused_mlp(d_in, d_out, g):
    # indices 0 and 3 hold the reference's Linears; 1 and 2 no parameters
    return nn.Sequential(TorchLinear(d_in, 64, generator=g), nn.ReLU(), nn.Identity(),
                         TorchLinear(64, d_out, generator=g))


def newz_step(consts, carry, xlp, xap, qm, drop):
    """One step of the recurrence, ``(carry, y)``: ``consts`` from
    ``MARN1NewZ.step_consts``, carry ``(h_l, c_l, h_a, c_a, z, q)`` with q
    ``[B, P, 512]``, xlp and xap this step's W projections ``[B, 512]``, qm
    its qmask ``[B, P]``, ``drop`` the 0.3 dropout (the identity in eval);
    y = [h_l | h_a | z], ``[B, 512]``."""
    (S_w, S_b, K_l, b_l, K_a, b_a, att, att_l, att_a, cross, fc_z, ws) = consts
    h_l, c_l, h_a, c_a, z, q = carry
    q0 = select_parties(q, qm)
    q_aff = torch.nn.functional.linear(q0, S_w, S_b)
    m = qm[..., None]
    q = q0[:, None, :] * (1.0 - m) + q_aff[:, None, :] * m
    c_l, h_l = lsthm_gates(xlp + torch.matmul(torch.cat([h_l, z, q_aff], -1), K_l) + b_l, c_l)
    c_a, h_a = lsthm_gates(xap + torch.matmul(torch.cat([h_a, z, q_aff], -1), K_a) + b_a, c_a)
    new_cs = torch.cat([c_l, c_a], 1)
    attended = _multi_att(att(new_cs), new_cs, D)
    attended_l = _multi_att(drop(torch.relu(att_l(c_l))), c_l, H)
    attended_a = _multi_att(drop(torch.relu(att_a(c_a))), c_a, H)
    cross_modal = drop(torch.relu(cross(torch.cat([attended_l, attended_a], -1))))
    z_flat = torch.cat([cross_modal, attended], -1).reshape(z.shape[0], -1)
    z = ws[0] * torch.relu(fc_z(z_flat)) + ws[1] * z
    return (h_l, c_l, h_a, c_a, z, q), torch.cat([h_l, h_a, z], -1)


def recurrence(consts, carry, xlp, xap, qmask, drop):
    """``newz_step`` over all T steps from ``carry``: a Python loop, xlp
    and xap ``[T, B, 512]``, qmask ``[T, B, P]``; returns the stacked y,
    ``[T, B, 512]``."""
    ys = []
    for t in range(qmask.shape[0]):
        carry, y = newz_step(consts, carry, xlp[t], xap[t], qmask[t], drop)
        ys.append(y)
    return torch.stack(ys)


class MARN1NewZ(nn.Module):
    """MARN1_newz. Input x time-major ``[L, B, 1024 + d_audio]`` (it reads
    the first 200 dims), qmask ``[L, B, P]``; ``umask`` is accepted and not
    read. Returns ``(logits [B*L, n_classes], x_a, x_l)`` with x_a, x_l the
    encoded time-major features."""

    dropout_rate = 0.3  # after att_l, att_a and att_cross_modal, each step

    def __init__(self, n_classes: int = 6, causal_encoder: bool = False, *,
                 generator: torch.Generator, encoder_attention: str = "mha"):
        super().__init__()
        g = generator
        self.n_classes = n_classes
        self.causal_encoder = causal_encoder
        self.encoder_l = EncoderLayer(D_M, 50, 8, 40, 40, generator=g, attention=encoder_attention)
        self.encoder_a = EncoderLayer(D_M, 50, 8, 40, 40, generator=g, attention=encoder_attention)
        self.encoder_v = EncoderLayer(SPEAKER, 50, 8, 40, 40, generator=g,
                                      attention=encoder_attention)  # unused
        self.lsthm_l = LSTHM(D_M, H, D, SPEAKER, generator=g)
        self.lsthm_a = LSTHM(D_M, H, D, SPEAKER, generator=g)
        self.S = TorchLinear(SPEAKER, SPEAKER, generator=g)
        self.att = nn.Sequential(TorchLinear(D, K * D, generator=g))
        self.att_l = nn.Sequential(TorchLinear(H, K * H, generator=g))
        self.att_a = nn.Sequential(TorchLinear(H, K * H, generator=g))
        self.att_cross_modal = nn.Sequential(TorchLinear(D, REDUCE, generator=g))
        self.fc_z = nn.Sequential(TorchLinear(K * (D + REDUCE), D, generator=g))
        self.w = nn.Parameter(torch.ones(2))
        self.fc = _unused_mlp(REDUCE, D, g)  # unused
        self.g_attention = nn.ModuleDict({"trans": _unused_mlp(REDUCE, D, g)})  # unused
        # index 2 is the reference's Dropout(0.5) (nn_out_drop)
        self.nn_out = nn.Sequential(TorchLinear(2 * H + D, 32, generator=g), nn.ReLU(),
                                    Dropout(0.5), TorchLinear(32, n_classes, generator=g))

    def step_consts(self):
        """The step's weights: S, each cell's fused ``K = [U; V; S]`` with
        its summed bias, the attention Linears, and softmax(w)."""
        def fused(cell):
            K_ = torch.cat([cell.U.weight.T, cell.V.weight.T, cell.S.weight.T], 0)
            return K_, cell.U.bias + cell.V.bias + cell.S.bias
        return (self.S.weight, self.S.bias, *fused(self.lsthm_l), *fused(self.lsthm_a),
                self.att[0], self.att_l[0], self.att_a[0], self.att_cross_modal[0],
                self.fc_z[0], torch.softmax(self.w, 0))

    def init_carry(self, B: int, P: int, like: torch.Tensor):
        """The zero carry of ``newz_step`` for B rows and P parties, on
        ``like``'s device."""
        zeros = lambda *s: like.new_zeros(s)  # noqa: E731
        return (zeros(B, H), zeros(B, H), zeros(B, H), zeros(B, H), zeros(B, D),
                zeros(B, P, SPEAKER))

    def head(self, ys, generator=None):
        """Raw logits of the step outputs ``[..., 512]``."""
        lin, relu, drop, out = self.nn_out
        return out(drop(relu(lin(ys)), generator))

    def encode(self, x, generator=None):
        """``(x_l, x_a)``: the encoders on x's first 200 dims, time-major,
        under the causal mask when ``causal_encoder``."""
        L = x.shape[0]
        mask = torch.tril(x.new_ones(1, L, L)) if self.causal_encoder else None
        enc = lambda e, xx: e(xx.transpose(0, 1), generator, mask).transpose(0, 1)  # noqa: E731
        return enc(self.encoder_l, x[:, :, :D_M]), enc(self.encoder_a, x[:, :, D_M:2 * D_M])

    def forward(self, x, qmask, umask=None, generator: torch.Generator | None = None):
        """In train mode every dropout draws from ``generator``, which must
        be given and lie on the model's device; in eval it is not used."""
        g = train_generator(self, generator)
        x_l, x_a = self.encode(x, g)
        consts = self.step_consts()
        xlp, xap = self.lsthm_l.W(x_l), self.lsthm_a.W(x_a)
        drop = (partial(dropout, p=self.dropout_rate, generator=g) if g is not None
                else (lambda v: v))
        carry = self.init_carry(*qmask.shape[1:], xlp)
        out = self.head(recurrence(consts, carry, xlp, xap, qmask, drop), g)  # [L, B, C]
        return out.transpose(0, 1).reshape(-1, out.shape[-1]), x_a, x_l
