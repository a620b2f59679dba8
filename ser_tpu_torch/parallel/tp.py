"""Tensor parallelism over a (dp, tp) process grid (counterpart of
``ser_tpu/parallel/tp.py``).

The JAX package builds a 2-D ``(dp, tp)`` mesh, stores each weight and its
Adam moments sharded over ``'tp'`` by a shape rule (``param_spec``) and
leaves the activation shardings and the collectives to XLA's partitioner.
Here one process owns one device, and the world's processes form the same
grid, ``rank = dp_index * n_tp + tp_index`` (``make_grid``; JAX's
``devices[:n].reshape(n_dp, n_tp)``). A process stores only its shard of
each leaf the rule shards, so its parameters and Adam's moments take
1/n_tp of the memory for those leaves. Compute stays whole: every process
of a tp group gathers the whole weights at use (``gather_shards``, one
all-gather of one flat buffer), runs the one-process forward and backward
on them, and keeps its slice of each whole gradient. The processes of a tp
group see the same rows and draw the same dropouts, so their whole
gradients are equal and no sum over tp is needed; the dp groups sum the
shards' gradients over the rows, as ``--dp`` does. The step so equals the
one-process step.

At the reference's sizes (~2.6M parameters) this is, as the JAX module
says, head-room and not a memory necessity; splitting the products'
compute over the tp group waits on a train-step measurement that could
show it (ROADMAP).

The rule is the JAX package's, applied to the JAX leaf each port parameter
comes from (``compat.from_jax.to_jax_leaf``), on the dim that the leaf's
sharded axis lands on in the port's layout: a ``Linear`` weight is ``[in,
out]`` in JAX and ``[out, in]`` here, so it shards dim 0.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ser_tpu_torch.compat.from_jax import jax_layout, to_jax_leaf
from ser_tpu_torch.parallel.mesh import world


@dataclass(frozen=True)
class Grid:
    """This process's place in the (dp, tp) grid and its two groups: the
    processes of its dp row (``tp_group``, which hold the shards of one
    whole model) and of its tp column (``dp_group``, which hold the same
    shards and sum their gradients)."""
    n_dp: int
    n_tp: int
    dp_index: int
    tp_index: int
    tp_group: object
    dp_group: object


def make_grid(n_dp: int, n_tp: int) -> Grid:
    """Split the process group into the (n_dp, n_tp) grid: ``dp_index =
    rank // n_tp``, ``tp_index = rank % n_tp``. Every process must call it
    (the groups are made in the same order on all of them); the world's size
    must be ``n_dp * n_tp``."""
    rank, size = world()
    if n_dp * n_tp != size or not dist.is_initialized():
        raise ValueError(f"a ({n_dp}, {n_tp}) grid needs {n_dp * n_tp} processes "
                         f"in a process group, have {size}")
    tp_group = dp_group = None
    for i in range(n_dp):  # one tp group a dp row
        group = dist.new_group([i * n_tp + j for j in range(n_tp)])
        if rank // n_tp == i:
            tp_group = group
    for j in range(n_tp):  # one dp group a tp column
        group = dist.new_group([i * n_tp + j for i in range(n_dp)])
        if rank % n_tp == j:
            dp_group = group
    return Grid(n_dp, n_tp, rank // n_tp, rank % n_tp, tp_group, dp_group)


def param_spec(shape, n_tp: int) -> tuple:
    """The JAX package's shape rule as the entries of its ``PartitionSpec``:
    ``(None, "tp")`` for a 2-D leaf whose last (output) axis ``n_tp``
    divides, ``("tp",)`` for such a 1-D leaf, ``()`` (replicated) for every
    other."""
    if len(shape) == 2 and shape[1] % n_tp == 0 and shape[1] >= n_tp:
        return (None, "tp")
    if len(shape) == 1 and shape[0] % n_tp == 0 and shape[0] >= n_tp:
        return ("tp",)
    return ()


def _port_dim(index: np.ndarray, leaf: np.ndarray, axis: int, n_tp: int) -> int:
    """The dim of the port's ``index`` array whose ``n_tp`` chunks hold the
    same elements as ``leaf``'s (its JAX layout) chunks along ``axis``."""
    want = [np.sort(c, axis=None) for c in np.split(leaf, n_tp, axis)]
    for dim in range(index.ndim):
        if index.shape[dim] % n_tp == 0 and all(
                np.array_equal(np.sort(c, axis=None), w)
                for c, w in zip(np.split(index, n_tp, dim), want)):
            return dim
    raise ValueError(f"no dim of {index.shape} holds the JAX leaf's axis {axis} "
                     f"of {leaf.shape}")


def shard_dims(model: torch.nn.Module, n_tp: int) -> dict[str, int | None]:
    """Each parameter's sharded dim under ``n_tp`` ways, or None where the
    rule replicates its JAX leaf."""
    layout = jax_layout(model.state_dict())
    dims = {}
    for name, p in model.named_parameters():
        index = np.arange(p.numel()).reshape(tuple(p.shape))
        _, leaf = to_jax_leaf(name, index, layout)
        spec = param_spec(leaf.shape, n_tp)
        dims[name] = _port_dim(index, leaf, spec.index("tp"), n_tp) if spec else None
    return dims


def local_shard(whole: torch.Tensor, dim: int, grid: Grid) -> torch.Tensor:
    """This process's slice of ``whole`` along ``dim``, a copy."""
    size = whole.shape[dim] // grid.n_tp
    return whole.narrow(dim, grid.tp_index * size, size).clone(
        memory_format=torch.contiguous_format)


class _GatherShards(torch.autograd.Function):
    """Whole tensors from every tp process's shards, with one all-gather of
    one flat buffer; the backward keeps this process's slice of each whole
    gradient, and None where a whole tensor took no gradient (a dead
    parameter keeps ``.grad`` None)."""

    @staticmethod
    def forward(ctx, grid, dims, *shards):
        ctx.set_materialize_grads(False)
        ctx.grid, ctx.dims = grid, dims
        flat = torch.cat([s.reshape(-1) for s in shards])
        parts = [torch.empty_like(flat) for _ in range(grid.n_tp)]
        dist.all_gather(parts, flat, group=grid.tp_group)
        sizes = [s.numel() for s in shards]
        pieces = [part.split(sizes) for part in parts]
        return tuple(torch.cat([p[i].view_as(s) for p in pieces], dim)
                     for i, (s, dim) in enumerate(zip(shards, dims)))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, *(None if g is None else local_shard(g, dim, ctx.grid)
                              for g, dim in zip(grads, ctx.dims)))


def gather_shards(shards: list[torch.Tensor], dims: list[int],
                  grid: Grid) -> list[torch.Tensor]:
    """The whole tensors of ``shards`` (one f32 shard each, sharded along
    its entry of ``dims``), differentiable."""
    return list(_GatherShards.apply(grid, dims, *shards)) if shards else []


def _set_parameter(model: torch.nn.Module, name: str, value: torch.nn.Parameter) -> None:
    owner, _, leaf = name.rpartition(".")
    setattr(model.get_submodule(owner) if owner else model, leaf, value)


def shard_model_(model: torch.nn.Module, dims: dict[str, int | None], grid: Grid) -> None:
    """Replace each sharded parameter of ``model`` (whole, the same on every
    process) by this process's shard."""
    named = dict(model.named_parameters())
    with torch.no_grad():
        for name, dim in dims.items():
            if dim is not None:
                p = named[name]
                _set_parameter(model, name, torch.nn.Parameter(
                    local_shard(p, dim, grid), requires_grad=p.requires_grad))


@contextlib.contextmanager
def whole_parameters(model: torch.nn.Module, dims: dict[str, int | None], grid: Grid,
                     reshard: bool = False):
    """Inside, ``model`` holds whole parameters, gathered from the shards
    (every tp process must enter). On exit the shards come back, the same
    objects, so an optimizer's state still refers to them; with ``reshard``
    each first takes its slice of the whole parameter, which code inside
    may have changed (a checkpoint loaded into it)."""
    named = dict(model.named_parameters())
    names = [n for n, d in dims.items() if d is not None]
    with torch.no_grad():
        wholes = gather_shards([named[n] for n in names], [dims[n] for n in names], grid)
    for name, whole in zip(names, wholes):
        _set_parameter(model, name, torch.nn.Parameter(
            whole, requires_grad=named[name].requires_grad))
    try:
        yield
    finally:
        current = dict(model.named_parameters())
        with torch.no_grad():
            for name in names:
                if reshard:
                    named[name].copy_(local_shard(current[name], dims[name], grid))
                _set_parameter(model, name, named[name])
