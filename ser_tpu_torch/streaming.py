"""Streaming inference for MARN1_newz, one utterance at a time (counterpart
of ``ser_tpu/streaming.py``).

MARN1_newz's recurrence runs forward only, so its carry can persist across
calls: appending an utterance costs one encoder row per modality (the new
utterance's query against the history) and one recurrence step, not a
recompute of the dialogue. The reference's encoders attend over the whole
dialogue, so no exact emit-once stream of them exists; the stream computes
the model with a causal encoder instead, utterance t attending over 0..t.
Its contract: ``NewZStream`` equals ``MARN1NewZ(causal_encoder=True)``'s
batch forward on the same weights (``tests/test_torch_streaming.py``), and
its drift from the bidirectional forward is a measured property
(``python -m ser_tpu_torch.serve stream`` reports it).

The history is padded to ``max_len`` rows and masked by the live length, so
every append has the same shapes. The state (histories, carry) stays on the
model's device; the step count is a host int, and an append fetches only
the ``[C]`` logits row.
"""

from __future__ import annotations

import numpy as np
import torch

from ser_tpu_torch.models.marn_newz import D_M, MARN1NewZ, newz_step


def _encoder_row(enc, hist, row, live):
    """One encoder output row: the new utterance ``row`` ``[d]`` as the
    query against ``hist`` ``[Lmax, d]`` (its rows where ``live`` ``[Lmax]``
    is True; the new row included), as ``EncoderLayer`` computes that row
    in eval. ``EncoderLayer`` itself over the whole padded history, row t
    kept, gives the same row but took longer an append on an H100 (PERF.md
    §6), so the one-row form stays."""
    att, ffn = enc.slf_attn, enc.pos_ffn
    n, d_k, d_v = att.n_head, att.d_k, att.d_v
    q = att.w_qs(row).reshape(n, d_k)
    k = att.w_ks(hist).reshape(-1, n, d_k)
    v = att.w_vs(hist).reshape(-1, n, d_v)
    logits = torch.einsum("nd,knd->nk", q / d_k ** 0.5, k)
    attn = torch.softmax(logits.masked_fill(~live, -1e9), -1)
    out = att.layer_norm(att.fc(torch.einsum("nk,knd->nd", attn, v).reshape(n * d_v)) + row)
    return ffn.layer_norm(ffn.w_2(torch.relu(ffn.w_1(out))) + out)


class NewZStream:
    """A streaming session over one dialogue of a ``MARN1NewZ`` model.

    ``append(x_row, q_row)`` takes the utterance's feature row (the trainer's
    ``1024 + d_audio`` layout or its first 200 dims; the model reads x[:100]
    and x[100:200]) and its ``P``-way speaker one-hot, and returns the raw
    logits ``[C]`` as numpy; past ``max_len`` utterances it raises
    ``ValueError``. ``reset()`` starts a new dialogue."""

    def __init__(self, model: MARN1NewZ, max_len: int = 128, n_parties: int = 2):
        self.model = model.eval()
        self.max_len = max_len
        self.n_parties = n_parties
        self.device = next(model.parameters()).device
        with torch.no_grad():
            self.consts = model.step_consts()
        self.rows = torch.arange(max_len, device=self.device)
        self.reset()

    def reset(self):
        zeros = torch.zeros(self.max_len, D_M, device=self.device)
        self.t = 0
        self.hist_l, self.hist_a = zeros, zeros.clone()
        self.carry = self.model.init_carry(1, self.n_parties, zeros)

    def append(self, x_row, q_row) -> np.ndarray:
        if self.t >= self.max_len:
            raise ValueError(f"dialogue exceeds max_len={self.max_len}")
        m, t = self.model, self.t
        x = torch.as_tensor(np.asarray(x_row, np.float32)[:2 * D_M], device=self.device)
        qm = torch.as_tensor(np.asarray(q_row, np.float32), device=self.device)[None]
        with torch.inference_mode():
            self.hist_l[t], self.hist_a[t] = x[:D_M], x[D_M:]
            live = self.rows <= t
            enc_l = _encoder_row(m.encoder_l, self.hist_l, x[:D_M], live)
            enc_a = _encoder_row(m.encoder_a, self.hist_a, x[D_M:], live)
            self.carry, y = newz_step(self.consts, self.carry, m.lsthm_l.W(enc_l)[None],
                                      m.lsthm_a.W(enc_a)[None], qm, lambda v: v)
            logits = m.head(y)[0]
        self.t = t + 1
        return logits.cpu().numpy()
