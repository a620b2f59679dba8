"""The MARN family (counterpart of ``ser_tpu/models/hybrid_rnn.py``; ref
``model/HybridRNN*.py``).

- ``MARNAttention``: the Multi-Attention Recurrent Network. ``MARN_AT`` is
  its bimodal form (l, a; 7 classes), ``MARN_ATV`` its trimodal form (l, a,
  v: dims 100/100/512, hidden 128/16/64; 6 classes). One encoder a
  modality (d_inner 50), then one forward recurrence (``recurrence``): a
  3-term LSTHM a modality on ``[h_i, z]`` (gate order f, i, o, c-hat), a
  4-head softmax attention over the concatenated cell states, a reduce a
  modality, and ``fc`` (Linear -> ReLU -> Dropout(0.3) -> Linear) to the
  new z. The head emits softmax probabilities a step, rows TIME-major
  ``[T*B, C]`` (the reference concatenates the steps' outputs over time),
  which the registry marks ``logp_layout="tb"``.
- ``MARN``: the reference's live path degenerated to a BiLSTM fallback
  (``HybridRNN.py:87-168``, the true recurrence commented out): the
  bimodal ``MARNAttention``'s parameters, none of them used, and two
  bidirectional LSTMs on x[..., :100] and x[..., 100:200] with the
  attention form's head, as ``BiLSTM`` without encoders.

The parameters the forward never touches (MARN's whole attention form, the
encoders' ``pos_ffn.fc``) stay for the reference's keys; their ``.grad``
stays None. The recurrence reads no mask: padded steps are a suffix, and
their rows are masked out of the loss and the metrics.
"""

from __future__ import annotations

from functools import partial

import torch
from torch import nn

from ser_tpu_torch.models.bilstm import (D_M, DH_A, DH_L, apply_head, lstm_head,
                                         probs_head)
from ser_tpu_torch.ops.cells import LSTHM, lsthm_gates
from ser_tpu_torch.ops.encoder import EncoderLayer
from ser_tpu_torch.ops.layers import Dropout, TorchLinear, dropout, train_generator
from ser_tpu_torch.ops.rnn import TorchBiLSTM

# modality -> (input width, hidden width, reduce width)
MODALITIES = {"l": (D_M, 128, 16), "a": (D_M, 16, 128), "v": (512, 64, 100)}
K = 4  # attention heads


def recurrence(xprojs, consts, att, reduces, fc, drop):
    """The MARN recurrence over all T steps: a Python loop. ``xprojs`` the
    modalities' W projections ``[T, B, 4 dh_i]``, ``consts`` each
    modality's fused state product ``(K_i = [U_i; V_i], b_i)``, ``att``,
    ``reduces`` and ``fc`` the model's Linears, ``drop`` the 0.3 dropout
    after fc's ReLU (the identity in eval). Returns the steps' ``[h_l | h_a
    (| h_v) | z]``, ``[T, B, 2 total_h]``."""
    T, B = xprojs[0].shape[:2]
    dh = [xp.shape[-1] // 4 for xp in xprojs]
    total_h = sum(dh)
    fc0, _, _, fc3 = fc
    hs = [xprojs[0].new_zeros(B, d) for d in dh]
    cs = list(hs)
    z = xprojs[0].new_zeros(B, total_h)
    ys = []
    for t in range(T):
        for i, (K_i, b_i) in enumerate(consts):
            sums = xprojs[i][t] + torch.addmm(b_i, torch.cat([hs[i], z], -1), K_i)
            cs[i], hs[i] = lsthm_gates(sums, cs[i])
        new_cs = torch.cat(cs, 1)
        attended = torch.softmax(att(new_cs).reshape(B, K, total_h), -1) * new_cs[:, None, :]
        blocks = torch.split(attended, dh, dim=2)
        zin = torch.cat([red(blk.reshape(B, -1)) for red, blk in zip(reduces, blocks)], 1)
        z = fc3(drop(torch.relu(fc0(zin))))
        ys.append(torch.cat(hs + [z], -1))
    return torch.stack(ys)


class MARNAttention(nn.Module):
    """MARN_AT (``trimodal=False``) or MARN_ATV. Input x time-major
    ``[L, B, D]``: the modalities are consecutive slices from dim 0 (l
    100, a 100, v 512), so MARN_AT reads the reference trainer's first 200
    text dims and MARN_ATV the trimodal input ``[text 100 | audio | visual]``
    (on MELD its v slice spans audio and visual dims, as in the JAX package).
    qmask and umask are accepted and not read. Returns the probabilities
    ``[L*B, n_classes]``, time-major rows. In train mode every dropout draws
    from ``generator``, which must be given."""

    def __init__(self, n_classes: int, trimodal: bool, *, generator: torch.Generator,
                 encoder_attention: str = "mha"):
        super().__init__()
        g = generator
        self.names = "lav" if trimodal else "la"
        dims = [MODALITIES[m] for m in self.names]
        total_h = sum(dh for _, dh, _ in dims)
        for m, (d, dh, red) in zip(self.names, dims):
            setattr(self, f"encoder_{m}", EncoderLayer(d, 50, 8, 40, 40, generator=g,
                                                       attention=encoder_attention))
            setattr(self, f"lsthm_{m}", LSTHM(d, dh, total_h, None, generator=g))
            setattr(self, f"reduce_dim_nn_{m}",
                    nn.Sequential(TorchLinear(K * dh, red, generator=g)))
        self.att = nn.Sequential(TorchLinear(total_h, K * total_h, generator=g))
        # index 2 is the reference's Dropout(0.3)
        self.fc = nn.Sequential(TorchLinear(sum(red for _, _, red in dims), 64, generator=g),
                                nn.ReLU(), Dropout(0.3), TorchLinear(64, total_h, generator=g))
        self.nn_out = probs_head(2 * total_h, n_classes, g)

    def forward(self, x, qmask=None, umask=None, generator: torch.Generator | None = None):
        g = train_generator(self, generator)
        xprojs, consts, lo = [], [], 0
        for m in self.names:
            cell = getattr(self, f"lsthm_{m}")
            d = cell.W.weight.shape[1]
            xm = getattr(self, f"encoder_{m}")(x[:, :, lo:lo + d].transpose(0, 1), g)
            lo += d
            xprojs.append(cell.W(xm.transpose(0, 1)))
            consts.append((torch.cat([cell.U.weight.T, cell.V.weight.T]),
                           cell.U.bias + cell.V.bias))
        drop = (partial(dropout, p=self.fc[2].p, generator=g) if g is not None
                else (lambda v: v))
        reduces = [getattr(self, f"reduce_dim_nn_{m}")[0] for m in self.names]
        ys = recurrence(xprojs, consts, self.att[0], reduces, self.fc, drop)
        probs = apply_head(self.nn_out, ys, g)  # [T, B, C]
        return probs.reshape(-1, probs.shape[-1])


class MARN(MARNAttention):
    """MARN, the BiLSTM fallback: input x time-major ``[L, B, 1024 +
    d_audio]`` (it reads the first 200 dims); returns the probabilities
    ``[B*L, n_classes]``, batch-major rows. Nothing is drawn in train mode
    (its head's dropout is 0), but the generator rule is the others'."""

    def __init__(self, n_classes: int = 6, *, generator: torch.Generator,
                 encoder_attention: str = "mha"):
        super().__init__(n_classes, trimodal=False, generator=generator,
                         encoder_attention=encoder_attention)
        self.lstm_l = TorchBiLSTM(D_M, DH_L, generator=generator)
        self.lstm_a = TorchBiLSTM(D_M, DH_A, generator=generator)

    def forward(self, x, qmask=None, umask=None, generator: torch.Generator | None = None):
        g = train_generator(self, generator)
        return lstm_head(self, x[:, :, :D_M], x[:, :, D_M:2 * D_M], g)
