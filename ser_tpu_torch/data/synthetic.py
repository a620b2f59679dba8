"""Seeded synthetic batches at IEMOCAP shapes, numpy only.

Copies of the JAX package's ``data/synthetic.py::synthetic_batch`` and of
``bench.py::iemocap_eval_batch``: the same seed gives the same arrays.
"""

from __future__ import annotations

import numpy as np


def synthetic_batch(L=110, B=80, n_classes=6, seed=0, d_text=1024,
                    d_audio=100, d_visual=512, min_len=None, n_parties=2):
    """Padded time-major batch dict: r1..r4 ``[L, B, 1024]``, visuf, acouf,
    qmask ``[L, B, P]``, umask ``[B, L]``, label ``[B, L]``, vid."""
    rng = np.random.default_rng(seed)
    if min_len is None:
        min_len = max(1, L // 2)
    lengths = rng.integers(min_len, L + 1, size=B)
    batch = {}
    for name, d in (("r1", d_text), ("r2", d_text), ("r3", d_text),
                    ("r4", d_text), ("visuf", d_visual), ("acouf", d_audio)):
        batch[name] = rng.standard_normal((L, B, d)).astype(np.float32)
    sp = rng.integers(0, n_parties, size=(L, B))
    qmask = np.zeros((L, B, n_parties), dtype=np.float32)
    qmask[np.arange(L)[:, None], np.arange(B)[None, :], sp] = 1.0
    umask = (np.arange(L)[None, :] < lengths[:, None]).astype(np.float32)
    qmask *= umask.T[:, :, None]
    label = rng.integers(0, n_classes, size=(B, L)).astype(np.int32) \
        * umask.astype(np.int32)
    for name in ("r1", "r2", "r3", "r4", "visuf", "acouf"):
        batch[name] *= umask.T[:, :, None]
    batch["qmask"] = qmask
    batch["umask"] = umask
    batch["label"] = label
    batch["vid"] = [f"synth{i}" for i in range(B)]
    return batch


def iemocap_eval_batch(seed=0):
    """The IEMOCAP test split's shape: 31 dialogues, 1606 utterances at
    seed 0, padded to the longest (82). Returns ``(batch, n_utterances)``."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(20, 111, size=31)
    lengths = (lengths * (1623 / lengths.sum())).astype(int)
    lengths = np.maximum(lengths, 5)
    L, B = int(lengths.max()), len(lengths)
    batch = synthetic_batch(L=L, B=B, seed=seed + 1)
    umask = (np.arange(L)[None, :] < lengths[:, None]).astype(np.float32)
    batch["umask"] = umask
    sp = rng.integers(0, 2, size=(L, B))
    qmask = np.zeros((L, B, 2), dtype=np.float32)
    qmask[np.arange(L)[:, None], np.arange(B)[None, :], sp] = 1.0
    batch["qmask"] = qmask * umask.T[:, :, None]
    return batch, int(lengths.sum())
