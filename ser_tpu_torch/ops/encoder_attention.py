"""The encoder's self-attention chosen by name: ``--encoder_attention``
(counterpart of ``ser_tpu/ops/encoder_attention.py``).

``"mha"`` is the reference's own multi-head attention, which ``EncoderLayer``
builds itself. Every other kind in ``SEQUENCE_KINDS`` puts a zoo op in its
place (``ops/attention_zoo.py``) inside the same epilogue, dropout, residual
and LayerNorm, so the block keeps its shape and normalisation. A zoo op
attends over the whole padded sequence: it takes no mask and returns no
attention map. The kind is an argument of every model that builds an
encoder, never a global.
"""

from __future__ import annotations

import torch
from torch import nn

from ser_tpu_torch.ops.attention_zoo import (ExternalAttention, MobileViTv2Attention,
                                             MUSEAttention, ScaledDotProductAttention,
                                             SimplifiedScaledDotProductAttention)
from ser_tpu_torch.ops.layers import Dropout, TorchLayerNorm

SEQUENCE_KINDS = ("mha", "external", "self", "simplified_self", "mobilevit_v2", "muse")


def check_kind(kind: str) -> str:
    """``kind``, or ``ValueError`` (the JAX package's message) if it is not
    one of ``SEQUENCE_KINDS``."""
    if kind not in SEQUENCE_KINDS:
        raise ValueError(f"unknown encoder attention '{kind}'; choose from {SEQUENCE_KINDS}")
    return kind


def _heads(d_model: int) -> int:
    """The largest of 8, 4, 2 that divides ``d_model``, else 1 (4 heads of
    25 for the 100-wide encoders, 8 of 64 for newz's 512-wide one)."""
    for h in (8, 4, 2):
        if d_model % h == 0:
            return h
    return 1


class ZooSelfAttention(nn.Module):
    """A zoo op of ``kind`` on ``[B, L, d_model]``, then ``out_dropout``,
    the residual and ``layer_norm``. The op's parameters sit under ``op``."""

    def __init__(self, kind: str, d_model: int, dropout: float = 0.1, *,
                 generator: torch.Generator):
        super().__init__()
        D, g = d_model, generator
        self.kind = check_kind(kind)
        if kind == "external":
            self.op = ExternalAttention(D, generator=g)
        elif kind == "self":
            h = _heads(D)
            self.op = ScaledDotProductAttention(D, D // h, D // h, h, generator=g)
        elif kind == "simplified_self":
            self.op = SimplifiedScaledDotProductAttention(D, _heads(D), generator=g)
        elif kind == "mobilevit_v2":
            self.op = MobileViTv2Attention(D, generator=g)
        elif kind == "muse":
            h = _heads(D)
            self.op = MUSEAttention(D, D // h, D // h, h, generator=g)
        else:  # "mha" is EncoderLayer's own
            raise ValueError(f"ZooSelfAttention builds a zoo op, not '{kind}'")
        self.out_dropout = Dropout(dropout)
        self.layer_norm = TorchLayerNorm(D)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None,
                mask: torch.Tensor | None = None) -> torch.Tensor:
        """``mask`` is accepted for ``EncoderLayer``'s call and not used: a
        zoo op attends over every position, as in the JAX package (so
        MARN1_newz's causal encoder is not causal under a zoo kind)."""
        del mask
        if self.kind in ("external", "mobilevit_v2"):
            out = self.op(x)
        else:
            out = self.op(x, x, x, generator)
        return self.layer_norm(self.out_dropout(out, generator) + x)


def encoder_attention_of(keys) -> str:
    """The kind whose parameters a state dict's ``keys`` hold: each zoo op's
    names under ``slf_attn.op.`` are its own (``mk``: external; ``dy_paras``:
    muse; ``fc_i``: mobilevit_v2; ``fc_q`` without those: self; ``fc_o``
    alone: simplified_self); none means ``mha``."""
    ops = {k.split("slf_attn.op.", 1)[1].split(".")[0] for k in keys if "slf_attn.op." in k}
    if not ops:
        return "mha"
    for kind, mark in (("external", "mk"), ("muse", "dy_paras"), ("mobilevit_v2", "fc_i"),
                       ("self", "fc_q"), ("simplified_self", "fc_o")):
        if mark in ops:
            return kind
    raise ValueError(f"no encoder attention has the parameters {sorted(ops)}")
