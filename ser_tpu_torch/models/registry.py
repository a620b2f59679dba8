"""String-keyed model factory (counterpart of ``ser_tpu/models/registry.py``).

All 15 models of the JAX registry: the flagship ``MARN1_onlysp``, the six
ablation variants that run the rank-1 attention (``MARN1_sp``,
``MARN1_cf``, ``MARN1_azs``, ``MARN1_sps``, ``MARN1_nsps``,
``MARN1_no_en``), the two without it (``MARN1_mf``, ``MARN1_la``), the
unidirectional ``MARN1_newz``, and the baselines ``BiLSTM``, ``MARN``,
``MARN_AT``, ``MARN_ATV`` and ``DialogueRNN``. As in the JAX registry,
``MARN1_newz``, ``BiLSTM`` and ``MARN_ATV`` have 6 outputs and ``MARN_AT`` 7
whatever ``n_classes`` says; the others' head has ``n_classes`` outputs (6
for IEMOCAP, 3 or 7 for MELD).

Two input conventions, from a numpy batch on the host:

- the reference trainer's (every model but ``MARN_ATV`` and
  ``DialogueRNN``): x = cat(mean of the four RoBERTa views, audio), 1024 +
  100 wide for IEMOCAP, 1024 + 300 for MELD;
- the legacy trimodal one (``MARN_ATV``, ``DialogueRNN``): x = cat(the
  RoBERTa mean's first 100 dims, audio, visual), 100 + 100 + 512 = 712 for
  IEMOCAP, 100 + 300 + 600 = 1000 for MELD (DialogueRNN refuses it, as the
  JAX package does).

Where the audio front end computes ``acouf`` on the device,
``text_features`` gives the host-side features around the audio slot and
``join_inputs`` puts the two tensors together there, audio in its place.

A model's first output (``extract_logp``) is ``[N, C]`` rows, log-probs or,
for BiLSTM, MARN, MARN_AT and MARN_ATV, probabilities (the masked loss
takes log-softmax on top, as in the JAX package); ``logp_layout`` says
their order: ``"bl"`` batch-major (row b·L + t), ``"tb"`` time-major (row
t·B + b; MARN_AT and MARN_ATV). ``rows`` and ``grid`` map a ``[B, L]``
array (labels, masks) to and from that order.

``build`` takes the encoders' self-attention kind (``--encoder_attention``,
``"mha"`` or a zoo op) as an argument; DialogueRNN has no encoder and takes
it unread. ``feature_outputs`` marks the eight models (as the JAX registry
does) whose output tuple carries the time-major features that the InfoNCE
term reads: ``(logp, x_l, x_a)``, for MARN1_newz ``(logits, x_a, x_l)``.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Callable

import numpy as np
import torch

from ser_tpu_torch.models.bilstm import BiLSTM
from ser_tpu_torch.models.dialogue_rnn import BiModel
from ser_tpu_torch.models.hybrid_rnn import MARN, MARNAttention
from ser_tpu_torch.models.marn_newz import MARN1NewZ
from ser_tpu_torch.models.marn_onlysp import MARN1OnlySP
from ser_tpu_torch.models.marn_variants import (MARN1AZS, MARN1CF, MARN1LA, MARN1MF,
                                                MARN1NSPS, MARN1SP, MARN1SPS)
from ser_tpu_torch.ops.encoder_attention import check_kind

TRIMODAL_TEXT = 100  # the RoBERTa mean's dims the trimodal input keeps


def _first(out):
    return out[0] if isinstance(out, tuple) else out


def _time_major_rows(out):
    """DialogueRNN's log-probs ``[L, B, C]`` as ``[B*L, C]`` rows."""
    return out[0].transpose(0, 1).reshape(-1, out[0].shape[-1])


@dataclass(frozen=True)
class ModelSpec:
    name: str
    build: Callable  # (n_classes, generator, encoder_attention="mha") -> nn.Module
    make_inputs: Callable  # (numpy batch dict) -> (x, qmask, umask) arrays
    text_features: Callable  # (numpy batch dict) -> x's host-side part, array
    join_inputs: Callable  # (text_features tensor, acouf tensor) -> x, on their device
    logp_layout: str = "bl"  # the rows' order: "bl" batch-major, "tb" time-major
    extract_logp: Callable = _first  # the model's output -> [N, C] rows
    # the output is (logp, query, negatives) time-major [L, B, D] features
    # that --infonce reads; the JAX registry's flag, not the tuple's length
    feature_outputs: bool = False

    def rows(self, a):
        """A ``[B, L]`` array or tensor flattened in the rows' order."""
        return (a.T if self.logp_layout == "tb" else a).reshape(-1)

    def grid(self, flat, B: int, L: int):
        """``rows``' inverse: flat per-row values back to ``[B, L]``."""
        return flat.reshape(L, B).T if self.logp_layout == "tb" else flat.reshape(B, L)


def _marn1_text(batch):
    return (batch["r1"] + batch["r2"] + batch["r3"] + batch["r4"]) / 4


def _marn1_inputs(batch):
    x = np.concatenate([_marn1_text(batch), batch["acouf"]], axis=-1)
    return x, batch["qmask"], batch["umask"]


def _join(textf, acouf):
    return torch.cat([textf, acouf], dim=-1)


def _trimodal_text(batch):
    """``[text 100 | visual]``, the trimodal input without its audio."""
    return np.concatenate([_marn1_text(batch)[..., :TRIMODAL_TEXT], batch["visuf"]], axis=-1)


def _trimodal_inputs(batch):
    x = np.concatenate([_marn1_text(batch)[..., :TRIMODAL_TEXT], batch["acouf"],
                        batch["visuf"]], axis=-1)
    return x, batch["qmask"], batch["umask"]


def _trimodal_join(text_visual, acouf):
    """``[text 100 | audio | visual]`` from ``_trimodal_text``'s features
    and the audio, tensors on one device."""
    return torch.cat([text_visual[..., :TRIMODAL_TEXT], acouf,
                      text_visual[..., TRIMODAL_TEXT:]], dim=-1)


# the models whose head has n_classes outputs and that take the trainer's input
_BUILDERS = {
    "MARN1_onlysp": MARN1OnlySP,
    "MARN1_sp": MARN1SP,
    "MARN1_cf": MARN1CF,
    "MARN1_azs": MARN1AZS,
    "MARN1_sps": MARN1SPS,
    "MARN1_nsps": MARN1NSPS,
    "MARN1_no_en": partial(MARN1NSPS, use_text_encoder=False),
    "MARN1_mf": MARN1MF,
    "MARN1_la": MARN1LA,
    "MARN": MARN,
}
# the eight models whose ModelSpec has feature_outputs=True in the JAX registry
_FEATURE_OUTPUTS = {"MARN1_onlysp", "MARN1_newz", "BiLSTM", "MARN1_sp", "MARN1_sps",
                    "MARN1_nsps", "MARN1_no_en", "MARN1_cf"}
_REGISTRY = {
    name: ModelSpec(name, lambda n_classes, generator, encoder_attention="mha", cls=cls: cls(
        n_classes, generator=generator, encoder_attention=encoder_attention),
        _marn1_inputs, _marn1_text, _join, feature_outputs=name in _FEATURE_OUTPUTS)
    for name, cls in _BUILDERS.items()}
# the JAX registry's fixed class counts (6 or 7 whatever --n_classes says)
_REGISTRY.update({
    "MARN1_newz": ModelSpec("MARN1_newz", lambda n, g, kind="mha": MARN1NewZ(
        6, generator=g, encoder_attention=kind), _marn1_inputs, _marn1_text, _join,
        feature_outputs=True),
    "BiLSTM": ModelSpec("BiLSTM", lambda n, g, kind="mha": BiLSTM(
        6, generator=g, encoder_attention=kind), _marn1_inputs, _marn1_text, _join,
        feature_outputs=True),
    "MARN_AT": ModelSpec("MARN_AT", lambda n, g, kind="mha": MARNAttention(
        7, False, generator=g, encoder_attention=kind), _marn1_inputs, _marn1_text, _join,
        logp_layout="tb"),
    "MARN_ATV": ModelSpec("MARN_ATV", lambda n, g, kind="mha": MARNAttention(
        6, True, generator=g, encoder_attention=kind), _trimodal_inputs, _trimodal_text,
        _trimodal_join, logp_layout="tb"),
    # no encoder: the kind is taken and not used, as in the JAX package
    "DialogueRNN": ModelSpec("DialogueRNN", lambda n, g, kind="mha": BiModel(generator=g),
                             _trimodal_inputs, _trimodal_text, _trimodal_join,
                             extract_logp=_time_major_rows),
})


def get_model_spec(name: str) -> ModelSpec:
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown model '{name}'; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def available_models():
    return sorted(_REGISTRY)


def build_model(name: str, generator: torch.Generator, n_classes: int = 6,
                encoder_attention: str = "mha") -> torch.nn.Module:
    """``name``'s model with ``encoder_attention``'s self-attention in its
    encoders (``ops.encoder_attention.SEQUENCE_KINDS``; an unknown kind
    raises ``ValueError``, also for DialogueRNN, which has no encoder)."""
    check_kind(encoder_attention)
    return get_model_spec(name).build(n_classes, generator, encoder_attention)
