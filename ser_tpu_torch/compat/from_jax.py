"""The JAX package's flattened MARN1_onlysp parameters as a port state dict.

``from_jax_params`` takes the flat names that the JAX package's
``train.checkpoint.flatten_params`` writes (``"marn_cell_f/lsthm_l_W_kernel"``,
``"encoder_l/slf_attn/w_qs/kernel"``, ...) and returns the reference-layout
torch keys the port's modules use. Dense kernels ``[in, out]`` are
transposed to ``[out, in]``; the per-step rank-1 attention vectors ``[D]``
become ``[1, D]``. This is the port's own copy of the mapping that the JAX
package's torch converter defines for MARN1_onlysp.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_LSTHM = re.compile(r"(lsthm_[la])_([WUVS])_(kernel|bias)")
_RNN = re.compile(r"(gru_s|lstm_q0|lstm_q1|lstm_s)_(ih|hh)_(kernel|bias)")
_RANK1 = re.compile(r"(crossatt_l2a|crossatt_a2l)_(W[qkv])")
_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias"}
_MODULE = {"nn_out_0": "nn_out.0", "nn_out_3": "nn_out.3"}


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
        key = ".".join(_MODULE.get(p, p) for p in head.split("/"))
        return f"{key}.{_LEAF[leaf]}", value.T if leaf == "kernel" else value
    elif head.startswith("crossatt_") and leaf in ("Wq", "Wk", "Wv"):
        return f"{head}.{leaf}", value
    elif not head and leaf in ("w", "v", "v1", "v2"):
        return leaf, value
    raise KeyError(f"no MARN1_onlysp home for JAX parameter '{name}'")


def from_jax_params(flat: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """Flat JAX MARN1_onlysp parameters -> the port's state dict."""
    out = {}
    for name, value in flat.items():
        key, v = _convert(name, np.asarray(value, dtype=np.float32))
        out[key] = torch.tensor(np.ascontiguousarray(v))
    return out
