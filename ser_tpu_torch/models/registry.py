"""String-keyed model factory (counterpart of ``ser_tpu/models/registry.py``).

One entry so far, the flagship ``MARN1_onlysp``. ``make_inputs`` follows the
reference trainer: x = cat(mean of the four RoBERTa views, audio).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ser_tpu_torch.models.marn_onlysp import MARN1OnlySP


@dataclass(frozen=True)
class ModelSpec:
    name: str
    build: Callable  # (n_classes, generator) -> nn.Module
    make_inputs: Callable  # (numpy batch dict) -> (x, qmask, umask) arrays


def _marn1_inputs(batch):
    textf = (batch["r1"] + batch["r2"] + batch["r3"] + batch["r4"]) / 4
    x = np.concatenate([textf, batch["acouf"]], axis=-1)
    return x, batch["qmask"], batch["umask"]


_REGISTRY = {
    "MARN1_onlysp": ModelSpec(
        "MARN1_onlysp",
        lambda n_classes, generator: MARN1OnlySP(n_classes,
                                                 generator=generator),
        _marn1_inputs),
}


def get_model_spec(name: str) -> ModelSpec:
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown model '{name}'; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def build_model(name: str, generator: torch.Generator,
                n_classes: int = 6) -> torch.nn.Module:
    return get_model_spec(name).build(n_classes, generator)
