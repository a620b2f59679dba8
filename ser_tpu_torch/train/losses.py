"""Losses (counterpart of ``ser_tpu/train/losses.py``): the masked
classification losses, ``masked_mse_loss``, ``unmasked_weighted_nll_loss``
and the InfoNCE term of ``--infonce``.

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
                outside_adds_zero: bool = False,
                denominator: torch.Tensor | float | None = None) -> torch.Tensor:
    """``MaskedLoss``: pred ``[N, C]`` log-probs (MARN1_newz's raw logits),
    target ``[N]`` int labels, mask ``[B, L]`` (or ``[N]``); kind
    ``CrossEntropy`` or ``NLL``; optional class weights ``[C]``. Returns the
    summed row loss over the mask's sum (over ``sum(weight[target] * mask)``
    with weights). A label at or past C raises, unless ``outside_adds_zero``:
    then its row adds 0, as the JAX package's all-zero one-hot of it does
    (MARN1_newz has 6 logits whatever the dataset's class count).
    ``denominator`` replaces that sum: under data parallelism a process's
    rows are divided by the global batch's, so the processes' losses sum to
    the global one."""
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
        return rowloss.sum() / (mask.sum() if denominator is None else denominator)
    w = weight[target]
    return (rowloss * w).sum() / ((w * mask_.reshape(-1)).sum() if denominator is None
                                  else denominator)


def masked_nll_loss(pred, target, mask, weight=None):
    """``MaskedNLLLoss``: ``masked_loss(kind="NLL")``."""
    return masked_loss(pred, target, mask, kind="NLL", weight=weight)


def masked_mse_loss(pred: torch.Tensor, target: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """``MaskedMSELoss``: flat ``[N]`` pred, target and mask;
    ``sum((pred·mask − target)²) / sum(mask)``."""
    return (pred * mask - target).square().sum() / mask.sum()


def unmasked_weighted_nll_loss(pred: torch.Tensor, target: torch.Tensor,
                               weight: torch.Tensor | None = None) -> torch.Tensor:
    """``UnMaskedWeightedNLLLoss``: pred ``[N, C]`` log-probs, target ``[N]``.
    Without weights it is the raw sum of the row losses, not a mean (the
    reference's quirk); with weights ``[C]`` the weighted sum over the sum of
    the rows' weights."""
    target = target.long().reshape(-1)
    rowloss = -pred.gather(1, target[:, None])[:, 0]
    if weight is None:
        return rowloss.sum()
    w = weight[target]
    return (rowloss * w).sum() / w.sum()


def info_nce(query: torch.Tensor, positive_key: torch.Tensor,
             negative_keys: torch.Tensor | None = None, temperature: float = 0.1,
             negative_mode: str = "unpaired", reduction: str = "mean") -> torch.Tensor:
    """InfoNCE. query and positive_key ``[N, D]``; negative_keys ``[M, D]``
    (``"unpaired"``) or ``[N, M, D]`` (``"paired"``), or None for in-batch
    negatives (the other rows' positives). Every input is divided by its
    norm, with no epsilon, as the JAX package does (an all-zero row gives
    NaN there too). ``reduction`` is ``"mean"``, ``"sum"`` or anything else
    for the ``[N]`` row losses."""
    def norm(x):
        return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)

    query, positive_key = norm(query), norm(positive_key)
    if negative_keys is not None:
        negative_keys = norm(negative_keys)
        positive_logit = (query * positive_key).sum(1, keepdim=True)
        if negative_mode == "unpaired":
            negative_logits = query @ negative_keys.T  # [N, M]
        elif negative_mode == "paired":
            negative_logits = torch.einsum("nd,nmd->nm", query, negative_keys)
        else:
            raise ValueError(f"unknown negative_mode: {negative_mode}")
        logits = torch.cat([positive_logit, negative_logits], 1)
        labels = torch.zeros(logits.shape[0], dtype=torch.long, device=logits.device)
    else:
        logits = query @ positive_key.T
        labels = torch.arange(logits.shape[0], device=logits.device)
    logp = torch.log_softmax(logits / temperature, dim=-1)
    losses = -logp.gather(1, labels[:, None])[:, 0]
    if reduction == "mean":
        return losses.mean()
    if reduction == "sum":
        return losses.sum()
    return losses
