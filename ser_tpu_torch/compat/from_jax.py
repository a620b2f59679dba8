"""The JAX package's flattened MARN1 parameters as a port state dict.

``from_jax_params`` takes the flat names that the JAX package's
``train.checkpoint.flatten_params`` writes (``"marn_cell_f/lsthm_l_W_kernel"``,
``"encoder_l/slf_attn/w_qs/kernel"``, ...) and returns the reference-layout
torch keys the port's modules use. Dense kernels ``[in, out]`` are
transposed to ``[out, in]``; the per-step rank-1 attention vectors ``[D]``
become ``[1, D]``. The mapping covers every model the port has
(``MARN1_onlysp`` and the variants sp, cf, azs, sps, nsps and no_en), and
for each its keys equal the JAX package's
``compat.torch_export.export_state_dict(params, NAME, prefix="")``. This is
the port's own copy of that mapping. ``to_jax_params`` is its inverse, which
writes a port state dict as the JAX package's checkpoint names.

The names differ from the keys in three ways: a cell's own parameters are
flat leaves (``lsthm_q_U_kernel`` is ``lsthm_q.U.weight``,
``gru_s_ih_kernel`` is ``gru_s.weight_ih``); a ``Sequential``'s index is
joined with an underscore (``nn_out_0``, ``fc_0``, ``fc2_0``); and azs's
cell encoders are ``marn_cell_f_encoder_l`` for ``marn_cell_f.encoder_l``.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_LSTHM = re.compile(r"(lsthm_[laq])_([WUVS])_(kernel|bias)")
_RNN = re.compile(r"(gru_s|gru_l|lstm_q0|lstm_q1|lstm_s)_(ih|hh)_(kernel|bias)")
_RANK1 = re.compile(r"(crossatt_l2a|crossatt_a2l)_(W[qkv])")
_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias"}
_SCALARS = ("w", "v", "v1", "v2", "p")
# a JAX module name that is two torch modules: a Sequential's index, azs's
# encoders inside a cell
_JOINED = re.compile(r"(nn_out|fc|fc2)_(\d+)|(marn_cell_[fb])_(encoder_[la])")


def _module_path(head: str) -> str:
    """A JAX module path (``a/b_0/c``) as a torch one (``a.b.0.c``)."""
    parts = []
    for part in head.split("/"):
        m = _JOINED.fullmatch(part)
        parts.extend([p for p in m.groups() if p] if m else [part])
    return ".".join(parts)


def _convert(name: str, value: np.ndarray):
    """``(torch key, value in torch layout)`` for one flat JAX name."""
    head, _, leaf = name.rpartition("/")
    if head in ("marn_cell_f", "marn_cell_b"):
        if m := _LSTHM.fullmatch(leaf):
            mod, mat, kind = m.groups()
            key = f"{head}.{mod}.{mat}.{_LEAF[kind]}"
            return key, value.T if kind == "kernel" else value
        if m := _RNN.fullmatch(leaf):
            cell, side, kind = m.groups()
            key = f"{head}.{cell}.{_LEAF[kind]}_{side}"
            return key, value.T if kind == "kernel" else value
        if m := _RANK1.fullmatch(leaf):
            return f"{head}.{m[1]}.{m[2]}", value.reshape(1, -1)
    elif leaf in _LEAF and head:
        return (f"{_module_path(head)}.{_LEAF[leaf]}",
                value.T if leaf == "kernel" else value)
    elif head.startswith("crossatt_") and "/" not in head and leaf in ("Wq", "Wk", "Wv"):
        return f"{head}.{leaf}", value
    elif not head and leaf in _SCALARS:
        return leaf, value
    raise KeyError(f"no MARN1 home for JAX parameter '{name}'")


def from_jax_params(flat: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """Flat JAX MARN1 parameters -> the port's state dict."""
    out = {}
    for name, value in flat.items():
        key, v = _convert(name, np.asarray(value, dtype=np.float32))
        out[key] = torch.tensor(np.ascontiguousarray(v))
    return out


_KEY_LSTHM = re.compile(r"(marn_cell_[fb])\.(lsthm_[laq])\.([WUVS])\.(weight|bias)")
_KEY_RNN = re.compile(r"(marn_cell_[fb])\.(gru_s|gru_l|lstm_q0|lstm_q1|lstm_s)\."
                      r"(weight|bias)_(ih|hh)")
_KEY_RANK1 = re.compile(r"(marn_cell_[fb])\.(crossatt_l2a|crossatt_a2l)\.(W[qkv])")
_KEY_SEQ_ATT = re.compile(r"(crossatt_\w+)\.(W[qkv])")
_KEY_JOINED = re.compile(  # whole dotted segments only
    r"(?<![^.])(?:(nn_out|fc|fc2)\.(\d+)|(marn_cell_[fb])\.(encoder_[la]))(?![^.])")


def _to_jax(key: str, v: np.ndarray):
    """``(flat JAX name, value in JAX layout)`` for one port key."""
    kind = {"weight": "kernel", "bias": "bias"}
    if m := _KEY_LSTHM.fullmatch(key):
        cell, mod, mat, leaf = m.groups()
        return f"{cell}/{mod}_{mat}_{kind[leaf]}", v.T if leaf == "weight" else v
    if m := _KEY_RNN.fullmatch(key):
        cell, rnn, leaf, side = m.groups()
        return f"{cell}/{rnn}_{side}_{kind[leaf]}", v.T if leaf == "weight" else v
    if m := _KEY_RANK1.fullmatch(key):
        return f"{m[1]}/{m[2]}_{m[3]}", v.reshape(-1)
    if m := _KEY_SEQ_ATT.fullmatch(key):
        return f"{m[1]}/{m[2]}", v
    if "." not in key:  # the fusion scalars w, v, v1, v2 and p
        return key, v
    head, leaf = key.rsplit(".", 1)
    head = _KEY_JOINED.sub(lambda m: "_".join(p for p in m.groups() if p), head)
    head = head.replace(".", "/")
    if leaf == "weight":  # a Dense kernel [out, in], or a LayerNorm scale
        return (f"{head}/kernel", v.T) if v.ndim == 2 else (f"{head}/scale", v)
    return f"{head}/{leaf}", v


def to_jax_params(state_dict) -> dict[str, np.ndarray]:
    """The port's state dict -> flat JAX MARN1 parameters, as the JAX
    package's ``save_parameters`` names them."""
    out = {}
    for key, value in state_dict.items():
        name, v = _to_jax(key, value.detach().cpu().numpy())
        out[name] = np.ascontiguousarray(v, dtype=np.float32)
    return out
