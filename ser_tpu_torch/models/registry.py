"""String-keyed model factory (counterpart of ``ser_tpu/models/registry.py``).

Ten entries so far: the flagship ``MARN1_onlysp``, the six ablation
variants that run the rank-1 attention (``MARN1_sp``, ``MARN1_cf``,
``MARN1_azs``, ``MARN1_sps``, ``MARN1_nsps``, ``MARN1_no_en``), the two
without it (``MARN1_mf``, ``MARN1_la``) and the unidirectional
``MARN1_newz``; ``QUEUED`` names the JAX package's models the port has not
yet. As in the JAX registry, ``MARN1_newz`` has 6 outputs whatever
``n_classes`` says. ``make_inputs``
follows the reference trainer for all of them: x = cat(mean of the four
RoBERTa views, audio), from a numpy batch on the host: 1024 + 100 wide for
IEMOCAP, 1024 + 300 for MELD (the models read the first 100 audio dims).
The head has ``n_classes`` outputs: 6 for IEMOCAP, 3 or 7 for MELD. Where
the audio front end computes ``acouf`` on the device, ``text_features``
gives the host-side mean alone and ``join_inputs`` concatenates the two
tensors there.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Callable

import numpy as np
import torch

from ser_tpu_torch.models.marn_newz import MARN1NewZ
from ser_tpu_torch.models.marn_onlysp import MARN1OnlySP
from ser_tpu_torch.models.marn_variants import (MARN1AZS, MARN1CF, MARN1LA, MARN1MF,
                                                MARN1NSPS, MARN1SP, MARN1SPS)


@dataclass(frozen=True)
class ModelSpec:
    name: str
    build: Callable  # (n_classes, generator) -> nn.Module
    make_inputs: Callable  # (numpy batch dict) -> (x, qmask, umask) arrays
    text_features: Callable  # (numpy batch dict) -> text part of x, array
    join_inputs: Callable  # (text tensor, acouf tensor) -> x, on their device


def _marn1_text(batch):
    return (batch["r1"] + batch["r2"] + batch["r3"] + batch["r4"]) / 4


def _marn1_inputs(batch):
    x = np.concatenate([_marn1_text(batch), batch["acouf"]], axis=-1)
    return x, batch["qmask"], batch["umask"]


def _join(textf, acouf):
    return torch.cat([textf, acouf], dim=-1)


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
    # the JAX registry builds newz with 6 outputs whatever --n_classes says
    "MARN1_newz": lambda n_classes, generator: MARN1NewZ(6, generator=generator),
}
_REGISTRY = {
    name: ModelSpec(name, lambda n_classes, generator, cls=cls: cls(
        n_classes, generator=generator), _marn1_inputs, _marn1_text, _join)
    for name, cls in _BUILDERS.items()}

# the JAX package's models still to port (ROADMAP A.10-A.12)
QUEUED = ("DialogueRNN", "BiLSTM", "MARN", "MARN_AT", "MARN_ATV")


def get_model_spec(name: str) -> ModelSpec:
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown model '{name}'; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def build_model(name: str, generator: torch.Generator,
                n_classes: int = 6) -> torch.nn.Module:
    return get_model_spec(name).build(n_classes, generator)
