"""Adam with coupled weight decay and StepLR (counterpart of
``ser_tpu/train/optim.py``).

The reference trains with ``torch.optim.Adam(lr, weight_decay=2e-5)``, whose
decay is added to the gradient before the moments (the JAX package chains
``add_decayed_weights`` before ``scale_by_adam`` for the same thing), and a
StepLR stepped every epoch: ``lr = lr0 * gamma ** ((epoch - 1) // step)``.

Dead parameters. The reference declares parameters it never uses
(MARN1_onlysp: ``crossatt_l2a.Wv``, ``crossatt_a2l.*``, ``lstm_q0``,
``lstm_q1``, ``lstm_s``, ``pos_ffn.fc``, ``linear``). Torch's Adam skips a
parameter whose ``.grad`` is None, so they stay at their init. That holds
here only because the port's forward never touches them, so backward never
gives them a gradient tensor: a zero tensor in their ``.grad`` (from code
that touches them, as the JAX package's parity declarations do) would let
the coupled decay move them by about lr a step. The JAX package reaches the
same result by freezing any leaf whose gradient is all zero
(``_mask_dead_params``).

One edge differs, and the port keeps torch's side of it: a LIVE parameter
whose gradient is all zero for a step (a fully padded batch) is frozen for
that step by the JAX package, while torch's Adam, and so the port, applies
the decay and the moments' update to it. The reference's data never meets
it.
"""

from __future__ import annotations

import torch


def torch_adam(params, lr: float = 1e-3, weight_decay: float = 2e-5,
               betas=(0.9, 0.999), eps: float = 1e-8) -> torch.optim.Adam:
    """``torch.optim.Adam`` with coupled weight decay; the trainer sets the
    learning rate of each epoch from ``step_lr``."""
    return torch.optim.Adam(params, lr=lr, betas=betas, eps=eps,
                            weight_decay=weight_decay)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def step_lr(base_lr: float, gamma: float, step_size: int):
    """StepLR as a function of the 1-based epoch."""

    def lr_at(epoch: int) -> float:
        return base_lr * (gamma ** ((epoch - 1) // step_size))

    return lr_at
