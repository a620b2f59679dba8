"""Masked classification losses (counterpart of ``ser_tpu/train/losses.py``).

The models emit log-probabilities, and the default ``CrossEntropy`` kind
applies log-softmax a second time, as the reference's ``MaskedLoss`` does
(``loss.py:11,21`` with ``train.py:117``): that is the trained behaviour.
Masked rows are zeroed before the loss, not dropped, so each adds a constant
log(C) to the summed loss and exactly zero gradient.
"""

from __future__ import annotations

import torch


def masked_loss(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
                kind: str = "CrossEntropy", weight: torch.Tensor | None = None,
                outside_adds_zero: bool = False) -> torch.Tensor:
    """``MaskedLoss``: pred ``[N, C]`` log-probs (MARN1_newz's raw logits),
    target ``[N]`` int labels, mask ``[B, L]`` (or ``[N]``); kind
    ``CrossEntropy`` or ``NLL``; optional class weights ``[C]``. Returns the
    summed row loss over the mask's sum (over ``sum(weight[target] * mask)``
    with weights). A label at or past C raises, unless ``outside_adds_zero``:
    then its row adds 0, as the JAX package's all-zero one-hot of it does
    (MARN1_newz has 6 logits whatever the dataset's class count)."""
    mask_ = mask.reshape(-1, 1)
    masked_pred = pred * mask_
    if kind == "CrossEntropy":
        logp = torch.log_softmax(masked_pred, dim=-1)
    elif kind == "NLL":
        logp = masked_pred
    else:
        raise ValueError(f"unknown loss kind: {kind}")
    target = target.long().reshape(-1)
    if outside_adds_zero:
        inside = target < pred.shape[-1]
        rowloss = -logp.gather(1, torch.where(inside, target, 0)[:, None])[:, 0] * inside
    else:
        rowloss = -logp.gather(1, target[:, None])[:, 0]
    if weight is None:
        return rowloss.sum() / mask.sum()
    w = weight[target]
    return (rowloss * w).sum() / (w * mask_.reshape(-1)).sum()


def masked_nll_loss(pred, target, mask, weight=None):
    """``MaskedNLLLoss``: ``masked_loss(kind="NLL")``."""
    return masked_loss(pred, target, mask, kind="NLL", weight=weight)
