"""Determinism: seed Python's, numpy's and torch's generators (counterpart of
``ser_tpu/utils/seeding.py``, which returns a JAX key where this returns a
``torch.Generator``)."""

from __future__ import annotations

import random

import numpy as np
import torch


def seed_everything(seed: int) -> torch.Generator:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(int(seed))
