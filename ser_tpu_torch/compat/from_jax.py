"""The JAX package's flattened parameters as a port state dict.

``from_jax_params`` takes the flat names that the JAX package's
``train.checkpoint.flatten_params`` writes (``"marn_cell_f/lsthm_l_W_kernel"``,
``"encoder_l/slf_attn/w_qs/kernel"``, ...) and returns the reference-layout
torch keys the port's modules use. Dense kernels ``[in, out]`` are
transposed to ``[out, in]``; the per-step rank-1 attention vectors ``[D]``
become ``[1, D]``. The mapping covers all 15 models of the registry, and for
each its keys equal the JAX package's
``compat.torch_export.export_state_dict(params, NAME, prefix="")``. This is
the port's own copy of that mapping. ``to_jax_params`` is its inverse, which
writes a port state dict as the JAX package's checkpoint names
(``to_jax_leaf`` one key and value).

The names differ from the keys in these ways: a cell's own parameters are
flat leaves (``lsthm_q_U_kernel`` is ``lsthm_q.U.weight``,
``gru_s_ih_kernel`` is ``gru_s.weight_ih``, DialogueRNN's
``dialog_rnn_f/g_cell_ih_kernel`` is
``dialog_rnn_f.dialogue_cell.g_cell.weight_ih`` and its
``dialog_rnn_f/attention_transform_kernel`` is
``dialog_rnn_f.dialogue_cell.attention.transform.weight``), an LSTM's are
named after its weights (``lstm_l/weight_ih_l0_bias`` is
``lstm_l.bias_ih_l0``), and so are the root-level Linears of newz and of
the MARN family (``lsthm_l_W_kernel``, ``S_kernel``, ``att_0_kernel`` for
``att.0.weight``, ``reduce_dim_nn_v_0_kernel``, ``g_attention_trans_0_kernel``
for ``g_attention.trans.0.weight``) and DialogueRNN's
``matchatt_transform_kernel``; a ``Sequential``'s index is joined with an
underscore (``nn_out_0``, ``fc_0``, ``fc2_0``); and azs's cell encoders are
``marn_cell_f_encoder_l`` for ``marn_cell_f.encoder_l``, where mf's and
la's are modules of the cell (``marn_cell_f/encoder_l``, with their
sequence attentions ``marn_cell_f/crossatt_l2a/Wq``). One key can so have
two names (nsps's ``fc.0`` is the module ``fc_0``, newz's and MARN's the
leaf ``fc_0_kernel``), and ``to_jax_params`` reads which from the whole
state dict (``jax_layout``).

The DialogueRNN suite's extras (``models/dialogue_rnn_extras.py``) add a
unidirectional ``dialog_rnn`` beside ``dialog_rnn_f`` and ``dialog_rnn_r``,
whose 'simple' attention ``attention_scalar_kernel [D_g, 1]`` is
``dialogue_cell.attention.scalar.weight [1, D_g]``; a GRU's leaves
(``turn_rnn/weight_ih_l0_kernel``) are named as an LSTM's; an embedding
table (``embedding``, ``cnn_feat_extractor/embedding``) is the module's
``embedding.weight``; and the text CNN's ``conv{K}_kernel [K, E, F]`` for
K = 3, 4, 5 are ``convs.{K - 3}.weight [F, E, K]``.

Under a zoo ``--encoder_attention`` kind an encoder's ``slf_attn`` holds
``op``, whose leaves are flat: ``mk`` and ``mv`` (``[D, S]``, ``[S, D]``),
``fc_q_kernel`` and ``fc_i_bias`` of the Linears, MUSE's ``dy_paras`` and
its convolutions ``conv3_depth_kernel [k, h·d_v]`` and
``conv5_point_kernel [h·d_v, D]``. They become the vendored torch modules'
keys under ``<encoder>.slf_attn.op.``: ``mk.weight``, ``fc_q.weight``,
``conv3.depth_conv.weight [h·d_v, 1, k]``,
``conv5.pointwise_conv.weight [D, h·d_v, 1]``, kernels transposed. The JAX
package's ``torch_export`` has no home for these leaves (it logs and skips
them), so these keys are the port's own.

``zoo_from_jax`` and ``zoo_to_jax`` carry one attention-zoo class's
parameters (``ops/attention_zoo.py``; no model holds these) between the
JAX module's tree and the port module's state dict, by the table
``zoo_leaves`` gives for the module: an HWIO kernel is OIHW, a Dense
kernel ``[in, out]`` is ``[out, in]`` (and ``[out, in, 1, 1]`` where the
vendored module has a 1x1 convolution), ECA's taps ``[k]`` are
``[1, 1, k]``, and ``<bn>_scale/_bias/_mean/_var`` are
``<bn>.weight/.bias/.running_mean/.running_var``. The keys are the
vendored torch modules'.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_LSTHM = re.compile(r"(lsthm_[laqv])_([WUVS])_(kernel|bias)")
_RNN = re.compile(r"(gru_s|gru_l|lstm_q0|lstm_q1|lstm_s|lstm_la_l|lstm_la_a)_(ih|hh)_"
                  r"(kernel|bias)")
_RANK1 = re.compile(r"(crossatt_l2a|crossatt_a2l)_(W[qkv])")
# DialogueRNN's cell leaves under ``dialog_rnn_[fr]``, and an LSTM's
_DRNN = re.compile(r"([gpel]_cell)_(ih|hh)_(kernel|bias)|attention_(transform|scalar)_"
                   r"(kernel|bias)")
_DRNN_HEADS = ("dialog_rnn", "dialog_rnn_f", "dialog_rnn_r")
# the text CNN's convolutions, by kernel width (CNNFeatureExtractor's
# kernel_sizes), and their module index
_CNN_WIDTHS = (3, 4, 5)
_CNN = re.compile(r"conv([345])_(kernel|bias)")
_LSTM = re.compile(r"weight_(ih|hh)_l0(_reverse)?_(kernel|bias)")
_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias"}
_SCALARS = ("w", "v", "v1", "v2", "p")
# a JAX module name that is two torch modules: a Sequential's index, azs's
# encoders inside a cell
_JOINED = re.compile(r"(nn_out|fc|fc2)_(\d+)|(marn_cell_[fb])_(encoder_[la])")
# newz's, the MARN family's and DialogueRNN's root-level Linears, declared
# as flat leaves: ``S_kernel``, ``att_cross_modal_0_bias``,
# ``g_attention_trans_3_kernel``, ``reduce_dim_nn_v_0_kernel``,
# ``matchatt_transform_bias``
_ROOT_LINEAR = re.compile(r"(S|att|att_l|att_a|att_cross_modal|fc_z|fc|g_attention_trans|"
                          r"reduce_dim_nn_[lav]|matchatt_transform)(?:_(\d+))?_(kernel|bias)")
_DOTTED = {"g_attention_trans": "g_attention.trans", "matchatt_transform": "matchatt.transform"}
_SEQ_ATT_HEAD = re.compile(r"(marn_cell_[fb]/)?crossatt_\w+")
# a zoo op's leaves under ``<encoder>/slf_attn/op``
_ZOO = re.compile(r"(mk|mv)|dy_paras|(fc_[qkvoi])_(kernel|bias)|(conv[135])_(depth|point)_"
                  r"(kernel|bias)")
_CONV = {"depth": "depth_conv", "point": "pointwise_conv"}


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
    t = lambda kind: value.T if kind == "kernel" else value  # noqa: E731
    dot = f"{head}." if head else ""
    if head in ("", "cnn_feat_extractor") and leaf == "embedding":
        return f"{dot}embedding.weight", value
    if head in ("", "cnn_feat_extractor") and (m := _CNN.fullmatch(leaf)):
        width, kind = m.groups()
        key = f"{dot}convs.{_CNN_WIDTHS.index(int(width))}.{_LEAF[kind]}"
        return key, value.transpose(2, 1, 0) if kind == "kernel" else value
    if head in ("marn_cell_f", "marn_cell_b", ""):
        if m := _LSTHM.fullmatch(leaf):
            mod, mat, kind = m.groups()
            return f"{dot}{mod}.{mat}.{_LEAF[kind]}", t(kind)
        if head and (m := _RNN.fullmatch(leaf)):
            cell, side, kind = m.groups()
            return f"{head}.{cell}.{_LEAF[kind]}_{side}", t(kind)
        if head and (m := _RANK1.fullmatch(leaf)):
            return f"{head}.{m[1]}.{m[2]}", value.reshape(1, -1)
        if not head and (m := _ROOT_LINEAR.fullmatch(leaf)):
            mod, idx, kind = m.groups()
            mod = _DOTTED.get(mod, mod)
            return f"{mod}.{idx + '.' if idx else ''}{_LEAF[kind]}", t(kind)
        if not head and leaf in _SCALARS:
            return leaf, value
    elif head in _DRNN_HEADS and (m := _DRNN.fullmatch(leaf)):
        cell, side, kind, att, att_kind = m.groups()
        if cell:
            return f"{head}.dialogue_cell.{cell}.{_LEAF[kind]}_{side}", t(kind)
        return f"{head}.dialogue_cell.attention.{att}.{_LEAF[att_kind]}", t(att_kind)
    elif head in ("lstm_l", "lstm_a", "turn_rnn") and (m := _LSTM.fullmatch(leaf)):
        side, rev, kind = m.groups()
        return f"{head}.{_LEAF[kind]}_{side}_l0{rev or ''}", t(kind)
    elif head.endswith("slf_attn/op") and (m := _ZOO.fullmatch(leaf)):
        return f"{_module_path(head)}.{_zoo_key(m)}", _zoo_value(m, value)
    elif leaf in _LEAF:
        return f"{_module_path(head)}.{_LEAF[leaf]}", t(leaf)
    elif _SEQ_ATT_HEAD.fullmatch(head) and leaf in ("Wq", "Wk", "Wv"):
        return f"{_module_path(head)}.{leaf}", value
    raise KeyError(f"no MARN1 home for JAX parameter '{name}'")


def _zoo_key(m) -> str:
    """The port's key, below ``op.``, of a zoo leaf matched by ``_ZOO``."""
    memory, fc, fc_kind, conv, part, conv_kind = m.groups()
    if memory:
        return f"{memory}.weight"
    if fc:
        return f"{fc}.{_LEAF[fc_kind]}"
    if conv:
        return f"{conv}.{_CONV[part]}.{_LEAF[conv_kind]}"
    return "dy_paras"


def _zoo_value(m, v: np.ndarray) -> np.ndarray:
    """A zoo leaf in torch layout: a Linear's kernel and a memory
    transposed, a depthwise kernel ``[k, C]`` as ``[C, 1, k]``, a pointwise
    one ``[C, D]`` as ``[D, C, 1]``."""
    memory, _, fc_kind, _, part, conv_kind = m.groups()
    if memory or fc_kind == "kernel":
        return v.T
    if conv_kind == "kernel":
        return v.T[:, None, :] if part == "depth" else v.T[:, :, None]
    return v


def from_jax_params(flat: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """Flat JAX parameters of a registry model -> the port's state dict."""
    out = {}
    for name, value in flat.items():
        key, v = _convert(name, np.asarray(value, dtype=np.float32))
        out[key] = torch.tensor(np.ascontiguousarray(v))
    return out


_KEY_LSTHM = re.compile(r"(?:(marn_cell_[fb])\.)?(lsthm_[laqv])\.([WUVS])\.(weight|bias)")
_KEY_RNN = re.compile(r"(marn_cell_[fb])\.(gru_s|gru_l|lstm_q0|lstm_q1|lstm_s|lstm_la_l|"
                      r"lstm_la_a)\.(weight|bias)_(ih|hh)")
_KEY_RANK1 = re.compile(r"(marn_cell_[fb])\.(crossatt_l2a|crossatt_a2l)\.(W[qkv])")
_KEY_SEQ_ATT = re.compile(r"(crossatt_\w+)\.(W[qkv])")
_KEY_ROOT_LINEAR = re.compile(r"(S|att|att_l|att_a|att_cross_modal|fc_z|fc|g_attention\.trans|"
                              r"reduce_dim_nn_[lav]|matchatt\.transform)(?:\.(\d+))?\."
                              r"(weight|bias)")
_KEY_DRNN = re.compile(r"(dialog_rnn(?:_[fr])?)\.dialogue_cell\.(?:([gpel]_cell)\.(weight|bias)_"
                       r"(ih|hh)|attention\.(transform|scalar)\.(weight|bias))")
_KEY_LSTM = re.compile(r"(lstm_[la]|turn_rnn)\.(weight|bias)_(ih|hh)_l0(_reverse)?")
_KEY_CNN = re.compile(r"(?:(cnn_feat_extractor)\.)?(?:(embedding)\.weight|convs\.([012])\."
                      r"(weight|bias))")
_KEY_JOINED = re.compile(  # whole dotted segments only
    r"(?<![^.])(?:(nn_out|fc|fc2)\.(\d+)|(marn_cell_[fb])\.(encoder_[la]))(?![^.])")
_KEY_SEQ_JOINED = re.compile(r"(?<![^.])(nn_out|fc|fc2)\.(\d+)(?![^.])")
_KEY_ZOO = re.compile(r"((?:.+\.)?slf_attn\.op)\.(?:(mk|mv)\.weight|(dy_paras)|(fc_[qkvoi])\."
                      r"(weight|bias)|(conv[135])\.(depth_conv|pointwise_conv)\.(weight|bias))")


def jax_layout(state_dict) -> str:
    """How the JAX package names a model's parameters: ``"leaves"`` (newz,
    the MARN family and DialogueRNN: their root-level Linears are flat
    leaves), ``"cells"`` (mf and la: the cells hold their encoders and
    sequence attentions, whose W is a matrix, as modules) or ``"flat"``
    (every other model)."""
    if any(k in state_dict for k in ("S.weight", "att.0.weight", "matchatt.transform.weight")):
        return "leaves"
    wq = state_dict.get("marn_cell_f.crossatt_l2a.Wq")
    return "cells" if wq is not None and wq.shape[0] > 1 else "flat"


def to_jax_leaf(key: str, v: np.ndarray, layout: str = "flat"):
    """``(flat JAX name, value in JAX layout)`` for one port key of a model
    named by ``layout`` (``jax_layout``)."""
    kind = {"weight": "kernel", "bias": "bias"}
    if m := _KEY_LSTHM.fullmatch(key):
        cell, mod, mat, leaf = m.groups()
        head = f"{cell}/" if cell else ""
        return f"{head}{mod}_{mat}_{kind[leaf]}", v.T if leaf == "weight" else v
    if m := _KEY_RNN.fullmatch(key):
        cell, rnn, leaf, side = m.groups()
        return f"{cell}/{rnn}_{side}_{kind[leaf]}", v.T if leaf == "weight" else v
    if m := _KEY_DRNN.fullmatch(key):
        head, cell, leaf, side, att, att_leaf = m.groups()
        if cell:
            return f"{head}/{cell}_{side}_{kind[leaf]}", v.T if leaf == "weight" else v
        return f"{head}/attention_{att}_{kind[att_leaf]}", v.T if att_leaf == "weight" else v
    if m := _KEY_CNN.fullmatch(key):
        head, emb, idx, leaf = m.groups()
        head = f"{head}/" if head else ""
        if emb:
            return f"{head}embedding", v
        name = f"{head}conv{_CNN_WIDTHS[int(idx)]}_{kind[leaf]}"
        return name, v.transpose(2, 1, 0) if leaf == "weight" else v
    if m := _KEY_LSTM.fullmatch(key):
        mod, leaf, side, rev = m.groups()
        return (f"{mod}/weight_{side}_l0{rev or ''}_{kind[leaf]}",
                v.T if leaf == "weight" else v)
    if layout == "leaves" and (m := _KEY_ROOT_LINEAR.fullmatch(key)):
        mod, idx, leaf = m.groups()
        name = mod.replace(".", "_") + (f"_{idx}" if idx else "")
        return f"{name}_{kind[leaf]}", v.T if leaf == "weight" else v
    if m := _KEY_RANK1.fullmatch(key):
        if layout == "cells":  # a sequence attention of the cell
            return f"{m[1]}/{m[2]}/{m[3]}", v
        return f"{m[1]}/{m[2]}_{m[3]}", v.reshape(-1)
    if m := _KEY_SEQ_ATT.fullmatch(key):
        return f"{m[1]}/{m[2]}", v
    if "." not in key:  # the fusion scalars w, v, v1, v2 and p
        return key, v
    if m := _KEY_ZOO.fullmatch(key):
        head, memory, dy, fc, fc_leaf, conv, part, conv_leaf = m.groups()
        head = _jax_head(head, layout)
        if memory:
            return f"{head}/{memory}", v.T
        if dy:
            return f"{head}/dy_paras", v
        if fc:
            return f"{head}/{fc}_{kind[fc_leaf]}", v.T if fc_leaf == "weight" else v
        depth = part == "depth_conv"
        name = f"{head}/{conv}_{'depth' if depth else 'point'}_{kind[conv_leaf]}"
        if conv_leaf == "weight":  # [C, 1, k] -> [k, C]; [D, C, 1] -> [C, D]
            v = v[:, 0, :].T if depth else v[:, :, 0].T
        return name, v
    head, leaf = key.rsplit(".", 1)
    head = _jax_head(head, layout)
    if leaf == "weight":  # a Dense kernel [out, in], or a LayerNorm scale
        return (f"{head}/kernel", v.T) if v.ndim == 2 else (f"{head}/scale", v)
    return f"{head}/{leaf}", v


def _jax_head(head: str, layout: str) -> str:
    """A torch module path as the JAX module path of a model named by
    ``layout``: a Sequential's index, and outside mf and la a cell's
    encoder, joined with an underscore."""
    joined = _KEY_SEQ_JOINED if layout == "cells" else _KEY_JOINED
    head = joined.sub(lambda m: "_".join(p for p in m.groups() if p), head)
    return head.replace(".", "/")


def to_jax_params(state_dict) -> dict[str, np.ndarray]:
    """The port's state dict (a whole model's, so that ``jax_layout`` can
    read its naming) -> flat JAX parameters, in its order, as the JAX
    package's ``save_parameters`` names them."""
    layout = jax_layout(state_dict)
    out = {}
    for key, value in state_dict.items():
        name, v = to_jax_leaf(key, value.detach().cpu().numpy(), layout)
        out[name] = np.ascontiguousarray(v, dtype=np.float32)
    return out



# --- one attention-zoo class's parameters -----------------------------------

# JAX layout -> torch layout, and back, by the name ``zoo_leaves`` gives it
_ZOO_TO_TORCH = {
    "same": lambda v: v,
    "linear": lambda v: v.T,
    "hwio": lambda v: v.transpose(3, 2, 0, 1),
    "1x1": lambda v: v.T[:, :, None, None],
    "taps": lambda v: v.reshape(1, 1, -1),
}
_ZOO_TO_JAX = {
    "same": lambda v: v,
    "linear": lambda v: v.T,
    "hwio": lambda v: v.transpose(2, 3, 1, 0),
    "1x1": lambda v: v[:, :, 0, 0].T,
    "taps": lambda v: v.reshape(-1),
}


def _conv(jax, key, bias=True, layout="hwio"):
    return [(f"{jax}_kernel", f"{key}.weight", layout)] + (
        [(f"{jax}_bias", f"{key}.bias", "same")] if bias else [])


def _linear(jax, key, bias=True):
    return _conv(jax, key, bias, "linear")


def _bn(jax, key):
    return [(f"{jax}_{a}", f"{key}.{b}", "same") for a, b in (
        ("scale", "weight"), ("bias", "bias"), ("mean", "running_mean"),
        ("var", "running_var"))]


def zoo_leaves(module) -> list[tuple[str, str, str]]:
    """``(JAX path, port key, layout)`` of every parameter and statistic of
    an attention-zoo module of the port, its configuration read from the
    module (SKAttention's kernels, BAMBlock's layers, PSA's groups, EMSA's
    ratio, ...). A JAX path joins nested modules with ``/`` (DAModule's
    ``pa/fc_q_kernel``, CBAMBlock's ``sa/conv_kernel``)."""
    name, m = type(module).__name__, module
    if name == "SEAttention":
        return [("fc1", "fc.0.weight", "linear"), ("fc2", "fc.2.weight", "linear")]
    if name == "ECAAttention":
        return [("conv_kernel", "conv.weight", "taps"), ("conv_bias", "conv.bias", "same")]
    if name == "CBAMChannelGate":
        return [("mlp1", "se.0.weight", "1x1"), ("mlp2", "se.2.weight", "1x1")]
    if name == "CBAMSpatialGate":
        return _conv("conv", "conv")
    if name == "CBAMBlock":
        return [("se1", "ca.se.0.weight", "1x1"), ("se2", "ca.se.2.weight", "1x1"),
                *_conv("sa/conv", "sa.conv")]
    if name in ("SpatialGroupEnhance", "ShuffleAttention"):
        own = ("weight", "bias") if name == "SpatialGroupEnhance" else (
            "cweight", "cbias", "sweight", "sbias")
        gn = [("gn_scale", "gn.weight", "same"), ("gn_bias", "gn.bias", "same")]
        return [(n, n, "same") for n in own] + (gn if name == "ShuffleAttention" else [])
    if name == "CoordAttention":
        return [*_conv("conv1", "conv1"), *_bn("bn1", "bn1"), *_conv("conv_h", "conv_h"),
                *_conv("conv_w", "conv_w")]
    if name == "TripletAttention":
        return [leaf for g in ("cw", "hc") + (() if m.no_spatial else ("hw",))
                for leaf in _conv(f"{g}_conv", f"{g}.conv.conv", bias=False)
                + _bn(f"{g}_bn", f"{g}.conv.bn")]
    if name == "SKAttention":
        out = _linear("fc", "fc")
        for i, k in enumerate(m.kernels):
            out += (_conv(f"conv{k}", f"convs.{i}.conv") + _bn(f"bn{k}", f"convs.{i}.bn")
                    + _linear(f"fcs{i}", f"fcs.{i}"))
        return out
    if name == "BAMBlock":
        out = []
        for i in range(m.num_layers):
            out += _linear(f"ca_fc{i}", f"ca.ca.fc{i}") + _bn(f"ca_bn{i}", f"ca.ca.bn{i}")
        out += _linear("ca_last_fc", "ca.ca.last_fc")
        out += _conv("sa_reduce", "sa.sa.conv_reduce1") + _bn("sa_reduce_bn", "sa.sa.bn_reduce1")
        for i in range(m.num_layers):
            out += _conv(f"sa_conv{i}", f"sa.sa.conv_{i}") + _bn(f"sa_bn{i}", f"sa.sa.bn_{i}")
        return out + _conv("sa_last_conv", "sa.sa.last_conv")
    if name == "PSA":
        return [leaf for i in range(m.S) for leaf in _conv(f"conv{i}", f"convs.{i}")
                + _conv(f"se{i}_fc1", f"se_blocks.{i}.1", bias=False)
                + _conv(f"se{i}_fc2", f"se_blocks.{i}.3", bias=False)]
    if name == "CoTAttention":
        return [*_conv("key_conv", "key_embed.0", bias=False), *_bn("key_bn", "key_embed.1"),
                *_conv("value_conv", "value_embed.0", bias=False),
                *_bn("value_bn", "value_embed.1"),
                *_conv("att_conv1", "attention_embed.0", bias=False),
                *_bn("att_bn", "attention_embed.1"), *_conv("att_conv2", "attention_embed.3")]
    if name == "DoubleAttention":
        convs = ("convA", "convB", "convV") + (("conv_reconstruct",) if m.reconstruct else ())
        return [leaf for c in convs for leaf in _conv(c, c, layout="1x1")]
    if name == "DAModule":
        pam, cam = "position_attention_module", "channel_attention_module"
        return [*_conv("pos_cnn", f"{pam}.cnn"), *_conv("chan_cnn", f"{cam}.cnn"),
                *(leaf for n in "qkvo" for leaf in _linear(f"pa/fc_{n}", f"{pam}.pa.fc_{n}")),
                *_linear("ca/fc_o", f"{cam}.pa.fc_o")]
    if name == "PolarizedSelfAttention":
        return [leaf for c in ("ch_wv", "ch_wq", "ch_wz", "sp_wv", "sp_wq")
                for leaf in _conv(c, c)] + [("ln_scale", "ln.weight", "same"),
                                             ("ln_bias", "ln.bias", "same")]
    if name == "S2Attention":
        return [*_linear("mlp1", "mlp1"), *_linear("mlp2", "mlp2"),
                ("sa_mlp1_kernel", "split_attention.mlp1.weight", "linear"),
                ("sa_mlp2_kernel", "split_attention.mlp2.weight", "linear")]
    if name in ("AFTFull", "UFOAttention", "EMSA"):
        fcs = "qkv" if name == "AFTFull" else "qkvo"
        out = [leaf for n in fcs for leaf in _linear(f"fc_{n}", f"fc_{n}")]
        if name == "AFTFull":
            return out + ([] if m.simple else [("position_biases", "position_biases", "same")])
        if name == "UFOAttention":
            return out + [("gamma", "gamma", "same")]
        if m.ratio > 1:
            out += _conv("sr_conv", "sr_conv") + [("sr_ln_scale", "sr_ln.weight", "same"),
                                                  ("sr_ln_bias", "sr_ln.bias", "same")]
        return out + (_conv("transform_conv", "transform.conv") if m.apply_transform else [])
    leaves = _vision_leaves(name, m)
    if leaves is None:
        leaves = _backbone_leaves(name, m)
    if leaves is None:
        raise KeyError(f"no JAX parameter table for the zoo class {name}")
    return leaves


def _ln(jax, key):
    return [(f"{jax}_scale", f"{key}.weight", "same"), (f"{jax}_bias", f"{key}.bias", "same")]


def _mbconv(jax, key, m):
    """An MBConvBlock's leaves under the prefixes ``jax`` and ``key``."""
    out = (_conv(f"{jax}expand", f"{key}_expand_conv", bias=False)
           + _bn(f"{jax}expand_bn", f"{key}_bn0")) if m.expand else []
    return out + [*_conv(f"{jax}dw", f"{key}_depthwise_conv", bias=False),
                  *_bn(f"{jax}dw_bn", f"{key}_bn1"), *_conv(f"{jax}se_reduce", f"{key}_se_reduce"),
                  *_conv(f"{jax}se_expand", f"{key}_se_expand"),
                  *_conv(f"{jax}project", f"{key}_project_conv", bias=False),
                  *_bn(f"{jax}project_bn", f"{key}_bn2")]


def _vision_leaves(name, m):
    """The leaves of the classes of ``ops/attention_zoo_vision.py``, or None."""
    if name == "ResidualAttention":
        return _conv("fc", "fc", bias=False)
    if name == "ParNetAttention":
        return [*_conv("sse_conv", "sse.1"), *_conv("conv1", "conv1x1.0"),
                *_bn("bn1", "conv1x1.1"), *_conv("conv3", "conv3x3.0"), *_bn("bn3", "conv3x3.1")]
    if name == "CrissCrossAttention":
        return [*(leaf for c in ("query_conv", "key_conv", "value_conv") for leaf in _conv(c, c)),
                ("gamma", "gamma", "same")]
    if name == "WeightedPermuteMLP":
        bias = m.mlp_c.bias is not None
        return [*(leaf for b in "chw" for leaf in _linear(f"mlp_{b}", f"mlp_{b}", bias)),
                *_linear("reweight_fc1", "reweighting.fc1"),
                *_linear("reweight_fc2", "reweighting.fc2"), *_linear("proj", "proj")]
    if name == "OutlookAttention":
        return [*_linear("v_pj", "v_pj", bias=False), *_linear("attn", "attn"),
                *_linear("proj", "proj")]
    if name == "MobileViTAttention":
        out = [leaf for i in range(1, 5) for leaf in _conv(f"conv{i}", f"conv{i}")]
        for i in range(len(m.trans.layers)):
            attn, ffn, key = f"layer{i}_attn", f"layer{i}_ffn", f"trans.layers.{i}"
            out += [*_ln(f"{attn}_ln", f"{key}.0.ln"),
                    *_linear(f"{attn}_to_qkv", f"{key}.0.fn.to_qkv", bias=False),
                    *_linear(f"{attn}_to_out", f"{key}.0.fn.to_out.0"),
                    *_ln(f"{ffn}_ln", f"{key}.1.ln"), *_linear(f"{ffn}_fc1", f"{key}.1.fn.net.0"),
                    *_linear(f"{ffn}_fc2", f"{key}.1.fn.net.3")]
        return out
    if name == "GFNet":
        out = [*_conv("patch_proj", "patch_embed.proj"), *_linear("embedding", "embedding")]
        for i in range(len(m.blocks)):
            jax, key = f"block{i}", f"blocks.{i}"
            out += [*_ln(f"{jax}_norm1", f"{key}.norm1"),
                    (f"{jax}_complex_weight", f"{key}.filter.complex_weight", "same"),
                    *_ln(f"{jax}_norm2", f"{key}.norm2"), *_linear(f"{jax}_fc1", f"{key}.mlp.fc1"),
                    *_linear(f"{jax}_fc2", f"{key}.mlp.fc2")]
        return out + _linear("head", "head")
    if name == "HaloAttention":
        return [*_linear("to_q", "to_q", bias=False), *_linear("to_kv", "to_kv", bias=False),
                *_linear("to_out", "to_out"), ("rel_height", "rel_pos_emb.rel_height", "same"),
                ("rel_width", "rel_pos_emb.rel_width", "same")]
    if name == "ACmix":
        return [("rate1", "rate1", "same"), ("rate2", "rate2", "same"),
                *(leaf for c in ("conv1", "conv2", "conv3", "conv_p") for leaf in _conv(c, c)),
                *_conv("fc", "fc", bias=False), *_conv("dep_conv", "dep_conv", bias=False)]
    if name == "AxialAttention":
        return [leaf for i in range(2) for leaf in (
            _linear(f"axis{i}_to_q", f"axial_attentions.{i}.fn.to_q", bias=False)
            + _linear(f"axis{i}_to_kv", f"axial_attentions.{i}.fn.to_kv", bias=False)
            + _linear(f"axis{i}_to_out", f"axial_attentions.{i}.fn.to_out"))]
    if name == "MBConvBlock":
        return _mbconv("", "", m)
    if name == "CoAtNet":
        out = [*_conv("s0_0", "s0.0"), *_conv("s0_2", "s0.2")]
        for i in range(3):
            out += _conv(f"mlp{i}_0", f"mlp{i}.0") + _conv(f"mlp{i}_2", f"mlp{i}.2")
        out += _mbconv("s1/", "s1.", m.s1) + _mbconv("s2/", "s2.", m.s2)
        for s in ("s3", "s4"):
            out += [leaf for n in "qkvo" for leaf in _linear(f"{s}/fc_{n}", f"{s}.fc_{n}")]
        for i in (3, 4):
            out += _linear(f"mlp{i}_0", f"mlp{i}.0") + _linear(f"mlp{i}_2", f"mlp{i}.2")
        return out
    return None


def _backbone_leaves(name, m):
    """The leaves of the classes of ``ops/attention_zoo_transformers.py``, or None."""
    if name == "CrossFormer":
        out = [leaf for i in range(len(m.patch_embed.projs))
               for leaf in _conv(f"patch_proj{i}", f"patch_embed.projs.{i}")]
        out += _ln("patch_norm", "patch_embed.norm")
        for i, layer in enumerate(m.layers):
            for d in range(len(layer.blocks)):
                jax, key = f"layer{i}_block{d}", f"layers.{i}.blocks.{d}"
                out += [*_ln(f"{jax}_norm1", f"{key}.norm1"),
                        *_linear(f"{jax}_attn_qkv", f"{key}.attn.qkv"),
                        *_linear(f"{jax}_attn_proj", f"{key}.attn.proj"),
                        *_linear(f"{jax}_attn_pos_proj", f"{key}.attn.pos.pos_proj")]
                for j in (1, 2, 3):
                    out += (_ln(f"{jax}_attn_pos{j}_ln", f"{key}.attn.pos.pos{j}.0")
                            + _linear(f"{jax}_attn_pos{j}_fc", f"{key}.attn.pos.pos{j}.2"))
                out += [*_ln(f"{jax}_norm2", f"{key}.norm2"),
                        *_linear(f"{jax}_mlp_fc1", f"{key}.mlp.fc1"),
                        *_linear(f"{jax}_mlp_fc2", f"{key}.mlp.fc2")]
            if layer.downsample is not None:
                down = f"layers.{i}.downsample"
                out += _ln(f"layer{i}_merge_norm", f"{down}.norm")
                out += [leaf for j in range(len(layer.downsample.reductions))
                        for leaf in _conv(f"layer{i}_merge_red{j}", f"{down}.reductions.{j}")]
        return out + _ln("norm", "norm") + _linear("head", "head")
    if name == "MOATransformer":
        out = [*_conv("patch_proj", "patch_embed.proj"), *_ln("patch_norm", "patch_embed.norm")]
        for i, layer in enumerate(m.layers):
            for d in range(len(layer.blocks)):
                jax, key = f"layer{i}_block{d}", f"layers.{i}.blocks.{d}"
                out += [*_ln(f"{jax}_norm1", f"{key}.norm1"),
                        (f"{jax}_attn_rpb_table", f"{key}.attn.relative_position_bias_table",
                         "same"),
                        *_linear(f"{jax}_attn_qkv", f"{key}.attn.qkv"),
                        *_linear(f"{jax}_attn_proj", f"{key}.attn.proj"),
                        *_ln(f"{jax}_norm2", f"{key}.norm2"),
                        *_linear(f"{jax}_mlp_fc1", f"{key}.mlp.fc1"),
                        *_linear(f"{jax}_mlp_fc2", f"{key}.mlp.fc2")]
            key = f"layers.{i}"
            if layer.glb_attn is not None:
                glb = f"{key}.glb_attn"
                out += [*_ln(f"layer{i}_gnorm1", f"{key}.norm1"),
                        *_ln(f"layer{i}_gnorm2", f"{key}.norm2"),
                        *_conv(f"layer{i}_post_conv", f"{key}.post_conv"),
                        *_conv(f"layer{i}_glb_pre_conv", f"{glb}.pre_conv"),
                        (f"layer{i}_glb_rpb_table", f"{glb}.relative_position_bias_table",
                         "same"),
                        *_linear(f"layer{i}_glb_q", f"{glb}.q"),
                        *_linear(f"layer{i}_glb_kv", f"{glb}.kv"),
                        *_linear(f"layer{i}_glb_proj", f"{glb}.proj")]
            if layer.downsample is not None:
                out += (_ln(f"layer{i}_merge_norm", f"{key}.downsample.norm")
                        + _linear(f"layer{i}_merge_red", f"{key}.downsample.reduction",
                                  bias=False))
        return out + _ln("norm", "norm") + _linear("head", "head")
    if name == "DAT":
        out = [*_conv("patch_proj", "patch_proj.0"), *_ln("patch_norm", "patch_proj.1.norm")]
        for i, stage in enumerate(m.stages):
            key = f"stages.{i}"
            if stage.proj is not None:
                out += _conv(f"stage{i}_proj", f"{key}.proj")
            for d, attn in enumerate(stage.attns):
                jax, att = f"stage{i}_block{d}", f"{key}.attns.{d}"
                out += [*_ln(f"{jax}_norm1", f"{key}.layer_norms.{2 * d}.norm"),
                        *_ln(f"{jax}_norm2", f"{key}.layer_norms.{2 * d + 1}.norm")]
                if hasattr(attn, "proj_qkv"):  # L or S
                    out += [(f"{jax}_attn_rpb_table", f"{att}.relative_position_bias_table",
                             "same"), *_linear(f"{jax}_attn_qkv", f"{att}.proj_qkv"),
                            *_linear(f"{jax}_attn_proj", f"{att}.proj_out")]
                else:  # D
                    out += [leaf for p in ("q", "k", "v", "out")
                            for leaf in _conv(f"{jax}_attn_proj_{p}", f"{att}.proj_{p}")]
                    out += [*_conv(f"{jax}_attn_off_conv", f"{att}.conv_offset.0"),
                            *_ln(f"{jax}_attn_off_ln", f"{att}.conv_offset.1.norm"),
                            *_conv(f"{jax}_attn_off_out", f"{att}.conv_offset.3", bias=False)]
                    if attn.use_pe:
                        out.append((f"{jax}_attn_rpe_table", f"{att}.rpe_table", "same"))
                out += (_linear(f"{jax}_mlp_fc1", f"{key}.mlps.{d}.chunk.linear1")
                        + _linear(f"{jax}_mlp_fc2", f"{key}.mlps.{d}.chunk.linear2"))
        for i in range(len(m.down_projs)):
            out += (_conv(f"down{i}", f"down_projs.{i}.0", bias=False)
                    + _ln(f"down{i}_norm", f"down_projs.{i}.1.norm"))
        return out + _ln("cls_norm", "cls_norm.norm") + _linear("cls_head", "cls_head")
    return None


def zoo_from_jax(module, params) -> dict[str, torch.Tensor]:
    """One zoo class's JAX parameter tree (nested dicts of arrays, as
    ``init`` gives it under ``"params"``) -> ``module``'s state dict."""
    out = {}
    for path, key, layout in zoo_leaves(module):
        v = params
        for part in path.split("/"):
            v = v[part]
        v = _ZOO_TO_TORCH[layout](np.asarray(v, dtype=np.float32))
        out[key] = torch.tensor(np.ascontiguousarray(v))
    return out


def zoo_to_jax(module, state_dict=None) -> dict:
    """``module``'s state dict (its own by default) -> the JAX class's
    parameter tree, numpy arrays in nested dicts."""
    state_dict = module.state_dict() if state_dict is None else state_dict
    tree = {}
    for path, key, layout in zoo_leaves(module):
        *heads, leaf = path.split("/")
        node = tree
        for head in heads:
            node = node.setdefault(head, {})
        v = state_dict[key].detach().cpu().numpy()
        node[leaf] = np.ascontiguousarray(_ZOO_TO_JAX[layout](v), dtype=np.float32)
    return tree
