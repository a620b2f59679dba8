"""Data parallelism over dialogues with ``torch.distributed`` (counterpart
of ``ser_tpu/parallel/mesh.py``).

The JAX package builds a 1-D ``'dp'`` mesh, shards each batch over
dialogues, replicates the parameters and leaves the gradient psum to XLA's
partitioner. Here each process owns one device (one process a card under
``torchrun``; NCCL between cards, gloo on the CPU), loads its contiguous
rows of every global batch (``data.loaders.EpochLoader(process_index=...,
process_count=...)``) and runs the model on them; the trainer divides its
rows' summed loss by the global batch's mask sum, and ``all_reduce_grads``
sums the gradients over the processes, which gives the one-process
gradient. Parameters start equal (``broadcast_params``) and stay equal:
every process applies the same reduced gradient. Under a (dp, tp) grid
(``parallel/tp.py``) the reduce and the gather take the grid's dp group,
and the loaders the dp index and count: over the world, each gradient
would count n_tp times.

``DistributedDataParallel`` is not used: it averages the gradients, and its
handling of parameters that get no gradient would give the dead ones (the
reference's declared, never-used parameters, ``.grad`` None) a gradient,
which Adam's coupled decay would then move (``train/optim.py``).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def world() -> tuple[int, int]:
    """``(rank, world size)`` of the process group, ``(0, 1)`` without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def initialize_distributed(device="cuda") -> torch.device:
    """Join the process group ``torchrun`` describes in the environment
    (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``) and return this process's device. Without
    ``WORLD_SIZE`` it is a no-op that returns ``device``. On ``cuda`` the
    device is ``cuda:LOCAL_RANK`` and the backend NCCL; on the CPU gloo. A
    group the process already joined is kept. A failure to join raises."""
    dev = torch.device(device)
    if "WORLD_SIZE" not in os.environ:
        return dev
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method="env://")
    return dev


def local_batch_slice(process_index=None, process_count=None):
    """This process's contiguous row range of a global batch, as a function
    ``batch_size -> slice``, which raises ``ValueError`` where the batch does
    not divide over the processes. The defaults are the process group's."""
    rank, size = world()
    p = rank if process_index is None else process_index
    n = size if process_count is None else process_count

    def slicer(batch_size):
        if batch_size % n:
            raise ValueError(
                f"global batch {batch_size} not divisible by {n} processes")
        k = batch_size // n
        return slice(p * k, (p + 1) * k)

    return slicer


def all_reduce_grads(params, *extra: torch.Tensor, group=None) -> tuple[torch.Tensor, ...]:
    """Sum the live gradients (``.grad`` not None) of ``params`` over the
    processes of ``group`` (the world's by default; a tp grid's dp group)
    in place, with one all-reduce of one flat buffer, and return ``extra``
    (scalars such as the loss) summed in the same call. Every process must
    hold the same live set, which the same model on the same graph gives."""
    grads = [p.grad for p in params if p.grad is not None]
    parts = [g.reshape(-1) for g in grads] + [e.reshape(-1).to(grads[0].dtype)
                                              for e in extra]
    flat = torch.cat(parts)
    dist.all_reduce(flat, group=group)
    sizes = [t.numel() for t in parts]
    summed = flat.split(sizes)
    with torch.no_grad():
        torch._foreach_copy_(grads, [s.view_as(g) for s, g in zip(summed, grads)])
    return tuple(s.reshape(e.shape).to(e.dtype) for s, e in zip(summed[len(grads):], extra))


def _group_world(group) -> tuple[int, int]:
    """``(rank, size)`` in ``group``, the world's without one."""
    if group is None:
        return world()
    return dist.get_rank(group), dist.get_world_size(group)


class _GatherRows(torch.autograd.Function):
    """All-gather over dim 0 in rank order; the backward sums the output's
    gradient over the processes and keeps this process's rows."""

    @staticmethod
    def forward(ctx, t, group):
        rank, size = _group_world(group)
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(size)]
        dist.all_gather(parts, t, group=group)
        ctx.rows = slice(rank * t.shape[0], (rank + 1) * t.shape[0])
        ctx.group = group
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g[ctx.rows], None


def gather_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t`` of every process of ``group`` (the world's by default; a tp
    grid's dp group) concatenated over dim 0 in rank order (each process's
    rows of equal count), differentiable; ``t`` itself where the group has
    one process."""
    if _group_world(group)[1] == 1:
        return t
    return _GatherRows.apply(t, group)


def broadcast_params(model: torch.nn.Module) -> None:
    """Rank 0's parameters and buffers to every process, in one broadcast
    (the counterpart of ``replicate_params``)."""
    if world()[1] == 1:
        return
    tensors = [t for t in (*model.parameters(), *model.buffers()) if t.is_floating_point()]
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    dist.broadcast(flat, src=0)
    with torch.no_grad():
        for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
            t.copy_(part.view_as(t))
