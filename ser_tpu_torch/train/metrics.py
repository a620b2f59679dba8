"""Evaluation metrics: mask-weighted accuracy and weighted F1 (counterpart
of ``ser_tpu/train/metrics.py``).

The reference's sklearn calls ``accuracy_score(labels, preds,
sample_weight=masks)`` and ``f1_score(..., average='weighted',
sample_weight=masks)``, both scaled by 100 and rounded to 2 decimals, in
numpy.
"""

from __future__ import annotations

import numpy as np


def weighted_accuracy(labels, preds, masks) -> float:
    labels = np.asarray(labels)
    preds = np.asarray(preds)
    masks = np.asarray(masks, dtype=np.float64)
    total = masks.sum()
    if total == 0:
        return 0.0
    correct = ((labels == preds).astype(np.float64) * masks).sum()
    return round(float(correct / total) * 100, 2)


def weighted_f1(labels, preds, masks) -> float:
    """Weighted-average F1 with sample weights, as sklearn computes it:
    classes in labels or preds are scored, weighted by their (weighted)
    support among the true labels."""
    labels = np.asarray(labels)
    preds = np.asarray(preds)
    masks = np.asarray(masks, dtype=np.float64)
    f1s, supports = [], []
    for c in np.unique(np.concatenate([labels, preds])):
        tp = (((labels == c) & (preds == c)) * masks).sum()
        fp = (((labels != c) & (preds == c)) * masks).sum()
        fn = (((labels == c) & (preds != c)) * masks).sum()
        denom = 2 * tp + fp + fn
        f1s.append((2 * tp / denom) if denom > 0 else 0.0)
        supports.append(((labels == c) * masks).sum())
    supports = np.asarray(supports)
    if supports.sum() == 0:
        return 0.0
    return round(float((np.asarray(f1s) * supports).sum() / supports.sum()) * 100, 2)
