"""Checkpoints in the JAX package's format: ``save_parameters`` and the
tolerant ``load_parameters`` (counterparts of ``ser_tpu/train/checkpoint.py``
and, with ``torch_format``, of ``ser_tpu/compat/torch_import.py``).

``save_parameters`` writes the model's parameters as the JAX package's
``.npz`` of flat flax names (``compat.from_jax.to_jax_params``), through a
temporary file and ``os.replace``, so an interrupted save never truncates a
checkpoint. A file written by either package loads in the other.

The reference loads partially: a name the model does not have is skipped
with a print, a shape mismatch is skipped with a print, and a leading
``module.``/``module/``/``model.``/``model/`` is stripped. Two formats:

- the JAX package's ``.npz`` of flat flax names (``save_parameters``); each
  name goes through ``compat.from_jax.from_jax_params``, and a name it cannot
  place is skipped with the same print;
- with ``torch_format``, a reference torch state dict (``torch.save`` of the
  trainer's ``state_dict()``), whose keys are the port's own.

Parameters the file does not carry keep their current values.
"""

from __future__ import annotations

import io
import os

import numpy as np
import torch

from ser_tpu_torch.compat.from_jax import from_jax_params, to_jax_params

_PREFIXES = ("module.", "module/", "model.", "model/")


def _candidates(name):
    yield name
    for prefix in _PREFIXES:
        if name.startswith(prefix):
            yield name[len(prefix):]


def _place_jax(name, value, own):
    """``(torch key, tensor)`` for a flat JAX name, or None."""
    for cand in _candidates(name):
        try:
            ((key, tensor),) = from_jax_params({cand: value}).items()
        except KeyError:
            continue
        if key in own:
            return key, tensor
    return None


def _place_torch(name, value, own):
    for cand in _candidates(name):
        if cand in own:
            return cand, value.detach().to("cpu", torch.float32).contiguous()
    return None


def save_parameters(model: torch.nn.Module, path) -> None:
    """Write ``model``'s parameters to ``path`` as the JAX package's
    ``save_parameters`` does (``np.savez`` of the flat names, atomically)."""
    path = os.fspath(path)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    buf = io.BytesIO()
    np.savez(buf, **to_jax_params(model.state_dict()))
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(buf.getvalue())
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def load_parameters(model: torch.nn.Module, path, torch_format=False,
                    log=print) -> list[str]:
    """Load what fits of the checkpoint at ``path`` into ``model`` and
    return the state-dict keys that were loaded."""
    own = model.state_dict()
    if torch_format:
        loaded = torch.load(path, map_location="cpu", weights_only=True)
        place = _place_torch
    else:
        with np.load(path, allow_pickle=False) as z:
            loaded = {k: z[k] for k in z.files}
        place = _place_jax
    accepted = {}
    for origname, value in loaded.items():
        placed = place(origname, value, own)
        if placed is None:
            log(f"{origname} is not in the model.")
            continue
        key, tensor = placed
        if tuple(own[key].shape) != tuple(tensor.shape):
            log(f"Wrong parameter length: {origname}, model: "
                f"{tuple(own[key].shape)}, loaded: {tuple(tensor.shape)}")
            continue
        accepted[key] = tensor
    model.load_state_dict(accepted, strict=False)
    return sorted(accepted)
