"""Evaluation metrics: mask-weighted accuracy, weighted F1 and top-k
accuracy (counterpart of ``ser_tpu/train/metrics.py``).

The reference's sklearn calls ``accuracy_score(labels, preds,
sample_weight=masks)`` and ``f1_score(..., average='weighted',
sample_weight=masks)``, both scaled by 100 and rounded to 2 decimals, and
its ``utils.py::accuracy`` (precision@k), in numpy.
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


def topk_accuracy(output, target, topk=(1,)):
    """Precision@k (ref ``utils.py:107-120``): output ``[N, C]`` scores,
    target ``[N]``; a percentage for each k, rounded to 4 decimals."""
    output = np.asarray(output)
    target = np.asarray(target)
    pred = np.argsort(-output, axis=1)[:, :max(topk)]  # best first
    correct = pred == target[:, None]
    return [round(float(correct[:, :k].any(axis=1).mean()) * 100, 4) for k in topk]


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
