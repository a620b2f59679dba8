"""A model's weights from the run's seed, made on the device in a few calls.

One ``torch.rand`` draw on a generator of the device covers every
parameter; each parameter is a slice of it, scaled to its own range from
the reference's parameter table (``reference.common.ParamTable``). The
same seed gives the same weights, which both the program (as a state dict)
and the reference (as float64 copies) are given.
"""

from __future__ import annotations

import torch


def make_weights(table, seed: int, device, dtype=torch.float32) -> dict:
    """name -> tensor on ``device``, in ``table``'s order."""
    sizes = [int(torch.Size(shape).numel()) for shape, _, _ in table.values()]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    u = torch.rand(sum(sizes), generator=gen, device=device, dtype=dtype)
    per = lambda k: torch.repeat_interleave(  # noqa: E731
        torch.tensor([v[k] for v in table.values()], dtype=dtype, device=device),
        torch.tensor(sizes, device=device), output_size=sum(sizes))
    flat = per(1) + per(2) * (2 * u - 1)
    return {name: part.view(shape) for (name, (shape, _, _)), part
            in zip(table.items(), flat.split(sizes))}
