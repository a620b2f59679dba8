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

TRIMODAL_TEXT = 100  # the RoBERTa mean's dims the trimodal input keeps


def _first(out):
    return out[0] if isinstance(out, tuple) else out


def _time_major_rows(out):
    """DialogueRNN's log-probs ``[L, B, C]`` as ``[B*L, C]`` rows."""
    return out[0].transpose(0, 1).reshape(-1, out[0].shape[-1])


@dataclass(frozen=True)
class ModelSpec:
    name: str
    build: Callable  # (n_classes, generator) -> nn.Module
    make_inputs: Callable  # (numpy batch dict) -> (x, qmask, umask) arrays
    text_features: Callable  # (numpy batch dict) -> x's host-side part, array
    join_inputs: Callable  # (text_features tensor, acouf tensor) -> x, on their device
    logp_layout: str = "bl"  # the rows' order: "bl" batch-major, "tb" time-major
    extract_logp: Callable = _first  # the model's output -> [N, C] rows

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
_REGISTRY = {
    name: ModelSpec(name, lambda n_classes, generator, cls=cls: cls(
        n_classes, generator=generator), _marn1_inputs, _marn1_text, _join)
    for name, cls in _BUILDERS.items()}
# the JAX registry's fixed class counts (6 or 7 whatever --n_classes says)
_REGISTRY.update({
    "MARN1_newz": ModelSpec("MARN1_newz", lambda n, g: MARN1NewZ(6, generator=g),
                            _marn1_inputs, _marn1_text, _join),
    "BiLSTM": ModelSpec("BiLSTM", lambda n, g: BiLSTM(6, generator=g),
                        _marn1_inputs, _marn1_text, _join),
    "MARN_AT": ModelSpec("MARN_AT", lambda n, g: MARNAttention(7, False, generator=g),
                         _marn1_inputs, _marn1_text, _join, logp_layout="tb"),
    "MARN_ATV": ModelSpec("MARN_ATV", lambda n, g: MARNAttention(6, True, generator=g),
                          _trimodal_inputs, _trimodal_text, _trimodal_join,
                          logp_layout="tb"),
    "DialogueRNN": ModelSpec("DialogueRNN", lambda n, g: BiModel(generator=g),
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


def build_model(name: str, generator: torch.Generator,
                n_classes: int = 6) -> torch.nn.Module:
    return get_model_spec(name).build(n_classes, generator)
