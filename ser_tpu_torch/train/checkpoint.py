"""Checkpoints in the JAX package's format: ``save_parameters`` and the
tolerant ``load_parameters`` (counterparts of ``ser_tpu/train/checkpoint.py``
and, with ``torch_format``, of ``ser_tpu/compat/torch_import.py``).

``save_parameters`` writes the model's parameters as the JAX package's
``.npz`` of flat flax names (``compat.from_jax.to_jax_params``), through a
temporary file and ``os.replace``, so an interrupted save never truncates a
checkpoint. A file written by either package loads in the other.

The reference loads partially: a name the model does not have is skipped
with a print, and a shape mismatch is skipped with a print. Two formats:

- the JAX package's ``.npz`` of flat flax names (``save_parameters``); at
  most one leading ``module.``/``module/``/``model.``/``model/`` is stripped
  from a name the model lacks, each name goes through
  ``compat.from_jax.from_jax_params``, and a name it cannot place is skipped
  with the same print;
- with ``torch_format``, a reference torch state dict (``torch.save`` of the
  trainer's ``state_dict()``), whose keys are the port's own once a leading
  ``module.`` and then a leading ``model.`` are stripped, as the JAX
  package's ``compat.torch_import.strip_prefixes`` strips them. As that
  package's importer does, it prints ``<key> is not in the checkpoint.`` for
  each key of the model the file lacks and ``<key> is not in the model.``
  for each key of the file the model lacks.

Parameters the file does not carry keep their current values.

``save_train_state`` / ``load_train_state`` (counterparts of the JAX
package's functions of the same names) keep what an exact resume needs in
one ``.npz`` of the port's own, written atomically: ``params/<key>`` for
every parameter, by its reference key; ``opt/<key>/{exp_avg, exp_avg_sq,
step}``, Adam's state; and ``extra/<name>`` arrays (the epoch, the
generator's state). A parameter that Adam has never stepped (a dead one:
its ``.grad`` stays None) is written with zero moments and step 0, and
loads back with no state, as torch's Adam leaves it. The load is strict:
a missing or misshapen parameter or optimizer leaf raises ``ValueError``.
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


def _strip_torch(name):
    """A reference torch key without its ``module.`` and then its ``model.``
    prefix (DataParallel's and the reference trainer's)."""
    for prefix in ("module.", "model."):
        if name.startswith(prefix):
            name = name[len(prefix):]
    return name


def load_torch_state_dict(path) -> dict:
    """A reference torch checkpoint (``torch.save`` of a state dict, or of
    a whole module) as ``{key: tensor}`` with each key's ``module.`` and
    then ``model.`` prefix stripped."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return {_strip_torch(k): v for k, v in sd.items()}


def place_torch(own_keys, sd: dict, log=print) -> dict:
    """The entries of a stripped torch state dict ``sd`` that a model with
    ``own_keys`` has, as f32 CPU tensors; prints ``<key> is not in the
    checkpoint.`` for each of its keys ``sd`` lacks and ``<key> is not in
    the model.`` for each key of ``sd`` it lacks (sorted)."""
    for key in own_keys:
        if key not in sd:
            log(f"{key} is not in the checkpoint.")
    for key in sorted(set(sd) - set(own_keys)):
        log(f"{key} is not in the model.")
    return {k: v.detach().to("cpu", torch.float32).contiguous()
            for k, v in sd.items() if k in own_keys}


def load_checked(model: torch.nn.Module, placed, log=print) -> list[str]:
    """Load ``placed`` (``(name in the file, key, tensor)`` triples) into
    ``model``, skipping with a print each tensor whose shape is not the
    model's; returns the loaded keys."""
    own = model.state_dict()
    accepted = {}
    for origname, key, tensor in placed:
        if tuple(own[key].shape) != tuple(tensor.shape):
            log(f"Wrong parameter length: {origname}, model: "
                f"{tuple(own[key].shape)}, loaded: {tuple(tensor.shape)}")
            continue
        accepted[key] = tensor
    model.load_state_dict(accepted, strict=False)
    return sorted(accepted)


def _atomic_savez(path, arrays: dict) -> None:
    """``np.savez`` of ``arrays`` to ``path`` through a temporary file,
    ``fsync`` and ``os.replace``: an interrupted save leaves the old file or
    the new one, never a truncated one."""
    path = os.fspath(path)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(buf.getvalue())
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def save_parameters(model: torch.nn.Module, path) -> None:
    """Write ``model``'s parameters to ``path`` as the JAX package's
    ``save_parameters`` does (``np.savez`` of the flat names, atomically)."""
    _atomic_savez(path, to_jax_params(model.state_dict()))


_ADAM_LEAVES = ("exp_avg", "exp_avg_sq", "step")


def save_train_state(path, params: dict, states: dict, extra: dict) -> None:
    """Write ``params`` (key -> parameter), Adam's state of each (``states``:
    key -> its ``optimizer.state`` entry, None or empty where Adam has never
    stepped it) and ``extra`` (name -> array) to ``path`` for an exact
    resume."""
    flat = {}
    for key, p in params.items():
        value = p.detach().cpu().numpy()
        flat[f"params/{key}"] = value
        state = states.get(key) or {
            "exp_avg": np.zeros_like(value), "exp_avg_sq": np.zeros_like(value),
            "step": np.float32(0)}
        for leaf in _ADAM_LEAVES:
            v = state[leaf]
            flat[f"opt/{key}/{leaf}"] = (v.detach().cpu().numpy()
                                         if torch.is_tensor(v) else np.asarray(v))
    for name, value in extra.items():
        flat[f"extra/{name}"] = np.asarray(value)
    _atomic_savez(path, flat)


def load_train_state(path, shapes: dict) -> tuple[dict, dict, dict]:
    """Read what ``save_train_state`` wrote for parameters of ``shapes``
    (key -> shape): ``(params, states, extra)``, key -> tensor, key -> Adam
    state (None where Adam had never stepped the parameter) and name ->
    array."""
    with np.load(path, allow_pickle=False) as z:
        loaded = {k: z[k] for k in z.files}
    params, states = {}, {}
    for key, shape in shapes.items():
        names = [f"params/{key}"] + [f"opt/{key}/{leaf}" for leaf in _ADAM_LEAVES]
        missing = [n for n in names if n not in loaded]
        if missing:
            raise ValueError(f"train-state file {path} lacks {missing}")
        for name in names[:3]:
            if loaded[name].shape != tuple(shape):
                raise ValueError(f"{name}: shape {loaded[name].shape} in {path}, "
                                 f"model has {tuple(shape)}")
        params[key] = torch.from_numpy(loaded[names[0]])
        states[key] = ({leaf: torch.from_numpy(loaded[n])
                        for leaf, n in zip(_ADAM_LEAVES, names[1:])}
                       if loaded[names[3]] != 0 else None)  # Adam has stepped it
    return params, states, {k[len("extra/"):]: v for k, v in loaded.items()
                            if k.startswith("extra/")}


def load_parameters(model: torch.nn.Module, path, torch_format=False,
                    log=print) -> list[str]:
    """Load what fits of the checkpoint at ``path`` into ``model`` and
    return the state-dict keys that were loaded."""
    own = model.state_dict()
    if torch_format:
        placed = [(k, k, v) for k, v in place_torch(
            own, load_torch_state_dict(path), log).items()]
    else:
        placed = []  # (name in the file, key, tensor)
        with np.load(path, allow_pickle=False) as z:
            loaded = {k: z[k] for k in z.files}
        for origname, value in loaded.items():
            found = _place_jax(origname, value, own)
            if found is None:
                log(f"{origname} is not in the model.")
            else:
                placed.append((origname, *found))
    return load_checked(model, placed, log)
