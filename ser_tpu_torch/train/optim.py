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

A LIVE parameter whose gradient is all zero for a step (a fully padded
batch) keeps its value for that step, as in the JAX package, whose mask
zeroes the update while Adam's moments and count still advance; torch's own
Adam would apply the decay to it. ``Adam.step`` restores such a parameter
after torch's step: the moments advance as optax's do. The reference's data
never meets it.

Under tensor parallelism (``parallel/tp.py``) a parameter here is a shard
of a JAX leaf, and the freeze is decided on the whole leaf, as
``_mask_dead_params`` decides it: one all-reduce of the shards' nonzero
flags over the tp group. A shard whose gradient is all zero is updated when
another shard of its leaf has a nonzero gradient.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class Adam(torch.optim.Adam):
    """``torch.optim.Adam``, except that a parameter whose gradient is all
    zero keeps its value for the step (the JAX package's
    ``_mask_dead_params``). The restore is a few device ops over all
    parameters at once (an infinity norm of every gradient, three ``cat``s,
    a ``where`` and a ``_foreach_copy_``), with no host sync. With
    ``tp_group`` the parameters are shards and a leaf is frozen only where
    every shard's gradient is all zero."""

    def __init__(self, params, tp_group=None, **kwargs):
        super().__init__(params, **kwargs)
        self.tp_group = tp_group

    def step(self, closure=None):
        params = [p for group in self.param_groups for p in group["params"]
                  if p.grad is not None]
        if not params:
            return super().step(closure)
        with torch.no_grad():
            norms = torch.stack(torch._foreach_norm([p.grad for p in params], float("inf")))
            if self.tp_group is None:
                frozen = norms == 0
            else:  # every tp process holds the same live set
                live = (norms != 0).float()
                dist.all_reduce(live, group=self.tp_group)
                frozen = live == 0
            before = torch.cat([p.reshape(-1) for p in params])
        loss = super().step(closure)
        with torch.no_grad():
            sizes = [p.numel() for p in params]
            after = torch.cat([p.reshape(-1) for p in params])
            mask = torch.cat([f.expand(n) for f, n in zip(frozen, sizes)])
            kept = torch.where(mask, before, after).split(sizes)
            torch._foreach_copy_(params, [k.view_as(p) for k, p in zip(kept, params)])
        return loss


def torch_adam(params, lr: float = 1e-3, weight_decay: float = 2e-5,
               betas=(0.9, 0.999), eps: float = 1e-8, tp_group=None,
               capturable: bool = False) -> Adam:
    """Adam with coupled weight decay; the trainer sets the learning rate of
    each epoch from ``step_lr``. ``tp_group``: the tp group whose processes
    hold the other shards of the parameters. ``capturable``: torch's form
    that a CUDA graph can hold (step counts on the device), with the
    learning rate a one-element tensor on the parameters' device, which
    ``set_lr`` writes in place, so a captured step reads each epoch's."""
    params = list(params)
    lr = float(lr)
    if capturable:
        lr = torch.tensor(lr, device=params[0].device)
    return Adam(params, tp_group=tp_group, lr=lr, betas=betas, eps=eps,
                weight_decay=weight_decay, capturable=capturable)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Every group's learning rate to ``lr``: a tensor one in place."""
    for group in optimizer.param_groups:
        if torch.is_tensor(group["lr"]):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr


def step_lr(base_lr: float, gamma: float, step_size: int):
    """StepLR as a function of the 1-based epoch."""

    def lr_at(epoch: int) -> float:
        return base_lr * (gamma ** ((epoch - 1) // step_size))

    return lr_at
