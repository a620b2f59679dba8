"""Plain PyTorch pieces that the benchmark's model references share.

Everything here is a function of tensors and a dict of parameters named as
the reference's torch modules name them (``linear_in.weight``,
``encoder_l.slf_attn.w_qs.weight``, ...). It imports nothing of the program:
it is the yardstick that the program is held to, written once from the
models' published equations (the MallVilliers reference's ``model/*.py``),
in the dtype of the tensors it is given (float64 in the benchmark's check).
Dropout is absent: the check steps run the program with every rate at 0.

The parameter table (``ParamTable``) lists each parameter's shape and the
range its random values are drawn from, so that ``benchmark.weights`` can
make a whole state dict on the card from a seed in a few calls. Every
parameter is random, also those that the reference initialises to a
constant (the sequence attentions' ones, LayerNorm, the rank-1 vectors, the
fusion scalars): at the constants an f32 step's gradients carry percents of
rounding noise against float64.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# Adam of the reference's train.py: torch.optim.Adam(lr, weight_decay) with
# torch's default betas and eps
BETAS = (0.9, 0.999)
EPS = 1e-8


class ParamTable(dict):
    """name -> (shape, centre, half-width): a parameter's values are drawn
    uniformly from ``centre +- half-width``."""

    def linear(self, name, d_in, d_out, bias=True):
        """``nn.Linear(d_in, d_out)``: U(+-1/sqrt(d_in)), torch's default."""
        bound = d_in ** -0.5
        self[f"{name}.weight"] = ((d_out, d_in), 0.0, bound)
        if bias:
            self[f"{name}.bias"] = ((d_out,), 0.0, bound)

    def rnn_cell(self, name, d_in, hidden, gates):
        """``nn.GRUCell`` (3 gates) or ``nn.LSTMCell`` (4): U(+-1/sqrt(hidden))."""
        bound = hidden ** -0.5
        for part, shape in (("weight_ih", (gates * hidden, d_in)),
                            ("weight_hh", (gates * hidden, hidden)),
                            ("bias_ih", (gates * hidden,)), ("bias_hh", (gates * hidden,))):
            self[f"{name}.{part}"] = (shape, 0.0, bound)

    def layer_norm(self, name, d):
        """LayerNorm, ones and zeros in the reference: 1 +- 0.1 and 0 +- 0.1."""
        self[f"{name}.weight"] = ((d,), 1.0, 0.1)
        self[f"{name}.bias"] = ((d,), 0.0, 0.1)

    def ones(self, name, shape):
        """A parameter the reference initialises to ones: a matrix gets the
        variance of N(0, 1/fan_in) (U(+-sqrt(3/fan_in))), a vector or a
        scalar 1 +- 0.1."""
        if len(shape) == 2 and shape[0] > 1:
            self[name] = (tuple(shape), 0.0, math.sqrt(3.0 / shape[0]))
        else:
            self[name] = (tuple(shape), 1.0, 0.1)

    def encoder(self, name, d_model, d_inner, n_head, d_k, d_v):
        """``EncoderLayer(d_model, d_inner, n_head, d_k, d_v)``: bias-free
        q, k, v and out projections, LayerNorm, the FFN (``fc`` declared,
        never used)."""
        a = f"{name}.slf_attn"
        self.linear(f"{a}.w_qs", d_model, n_head * d_k, bias=False)
        self.linear(f"{a}.w_ks", d_model, n_head * d_k, bias=False)
        self.linear(f"{a}.w_vs", d_model, n_head * d_v, bias=False)
        self.linear(f"{a}.fc", n_head * d_v, d_model, bias=False)
        self.layer_norm(f"{a}.layer_norm", d_model)
        f = f"{name}.pos_ffn"
        self.linear(f"{f}.w_1", d_model, d_inner)
        self.linear(f"{f}.w_2", d_inner, d_model)
        self.layer_norm(f"{f}.layer_norm", d_model)
        self.linear(f"{f}.fc", d_model, 100)

    def lsthm(self, name, d_in, H, four_term=True):
        """An LSTHM1 cell's W, U, V (and S) linears, all ``[4H, .]``."""
        self.linear(f"{name}.W", d_in, 4 * H)
        self.linear(f"{name}.U", H, 4 * H)
        self.linear(f"{name}.V", H, 4 * H)
        if four_term:
            self.linear(f"{name}.S", H, 4 * H)

    def rank1(self, name, D):
        """The per-step CrossAttention's Wq, Wk, Wv, ``[1, D]`` ones."""
        for part in ("Wq", "Wk", "Wv"):
            self.ones(f"{name}.{part}", (1, D))


MARN1_ENCODERS = ("encoder_l", "encoder_a")


def marn1_config_checks(config, params: ParamTable, D_R, D_M, H, ENC) -> list:
    """A MARN1 configuration file against its reference, as ``(what, one
    side, the other)`` triples whose sides must be equal: the file's widths
    against the shapes of the reference's parameter table ``params`` and its
    constants ``D_R`` (text), ``D_M`` (modality), ``H`` (hidden) and ``ENC``
    (the encoder's arguments)."""
    table = {n: shape for n, (shape, _, _) in params.items()}
    modality, text = table["linear_in.weight"]
    four_h, hidden = table["marn_cell_f.lsthm_l.U.weight"]
    d_hidden, d_feat = table["nn_out.0.weight"]
    enc = config["encoder"]
    checks = [
        ("linear_in's text and modality widths", (text, modality),
         (config["text_width"], config["modality_width"])),
        ("the reference's D_R and D_M", (text, modality), (D_R, D_M)),
        ("encoder_a's input, the audio width", table["encoder_a.slf_attn.w_qs.weight"][1],
         config["audio_width"]),
        ("input_width, text and audio", config["input_width"],
         config["text_width"] + config["audio_width"]),
        ("the LSTHM's four gates", four_h, 4 * hidden),
        ("the hidden width", hidden, config["hidden"]),
        ("the reference's H", hidden, H),
        ("the encoder's arguments", {k: enc[k] for k in ENC}, ENC),
    ]
    for side in MARN1_ENCODERS:
        checks += [
            (f"{side}'s q", table[f"{side}.slf_attn.w_qs.weight"],
             (enc["n_head"] * enc["d_k"], enc["d_model"])),
            (f"{side}'s v", table[f"{side}.slf_attn.w_vs.weight"],
             (enc["n_head"] * enc["d_v"], enc["d_model"])),
            (f"{side}'s FFN", table[f"{side}.pos_ffn.w_1.weight"],
             (enc["d_inner"], enc["d_model"])),
        ]
    return checks + [
        ("the head's widths", [d_feat, d_hidden, table["nn_out.3.weight"][0]], config["head"]),
        ("the head's classes", config["head"][-1], config["classes"]),
    ]


def marn1_dropout_group(module: str) -> str:
    """The MARN1 configuration's dropout key of a program module's rate
    (the module's name, or ``<module>.dropout_rate`` or
    ``<module>.attn_dropout`` for a float rate)."""
    if "encoder_" in module:
        return "encoder"
    if "crossatt" in module:
        return "sequence_attention"
    if module.endswith("attn_dropout"):
        return "rank1_attention"
    if module.startswith(("nn_out.", "fc.")):
        return "head"
    return "recurrence"


def linear(P, name, x, bias=True):
    return F.linear(x, P[f"{name}.weight"], P[f"{name}.bias"] if bias else None)


def layer_norm(P, name, x, eps=1e-6):
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * P[f"{name}.weight"] + P[f"{name}.bias"]


def encoder(P, name, x, n_head, d_k, d_v):
    """One encoder layer on batch-first ``[B, L, d]``: multi-head self
    attention over the whole padded sequence (the reference masks nothing),
    residual and LayerNorm, then the ReLU FFN, residual and LayerNorm."""
    a = f"{name}.slf_attn"
    B, L = x.shape[:2]
    q = linear(P, f"{a}.w_qs", x, False).reshape(B, L, n_head, d_k)
    k = linear(P, f"{a}.w_ks", x, False).reshape(B, L, n_head, d_k)
    v = linear(P, f"{a}.w_vs", x, False).reshape(B, L, n_head, d_v)
    attn = torch.softmax(torch.einsum("bqnd,bknd->bnqk", q / d_k ** 0.5, k), dim=-1)
    out = torch.einsum("bnqk,bknd->bqnd", attn, v).reshape(B, L, -1)
    x = layer_norm(P, f"{a}.layer_norm", linear(P, f"{a}.fc", out, False) + x)
    f = f"{name}.pos_ffn"
    h = linear(P, f"{f}.w_2", torch.relu(linear(P, f"{f}.w_1", x)))
    return layer_norm(P, f"{f}.layer_norm", h + x)


def reverse_seq(x, umask):
    """Each sequence's first ``sum(umask[b])`` steps reversed, the padded
    tail zero; x time-major ``[L, B, ...]``, umask ``[B, L]``."""
    L, B = x.shape[:2]
    lengths = umask.sum(1).round().to(torch.int64)
    t = torch.arange(L, device=x.device)[:, None]
    idx = torch.where(t < lengths[None], lengths[None] - 1 - t, t)
    tail = (1,) * (x.ndim - 2)
    out = torch.gather(x, 0, idx.reshape(idx.shape + tail).expand(x.shape))
    return out * (t < lengths[None]).to(x.dtype).reshape((L, B) + tail)


def speaker_onehot(qmask_t, P):
    """One-hot of ``argmax(qmask)``: a padded (all-zero) row is party 0."""
    idx = qmask_t.argmax(-1)
    return (idx[..., None] == torch.arange(P, device=qmask_t.device))


def select_parties(q, qmask_t):
    """The speaker's memory, ``[..., D]`` from q ``[..., P, D]``."""
    onehot = speaker_onehot(qmask_t, q.shape[-2]).to(q.dtype)
    return torch.einsum("...p,...pd->...d", onehot, q)


def scatter_parties(q, qmask_t, new):
    """``q * (1 - qmask) + new * qmask``: a padded step leaves q as it was."""
    m = qmask_t[..., None]
    return q * (1.0 - m) + new[..., None, :] * m


def gru_step(x_proj, h, Whh, bhh):
    """``nn.GRUCell`` with the x side given: gates r, z, n, r on the h side
    of n only. Whh ``[..., H, 3H]``."""
    H = h.shape[-1]
    hp = torch.matmul(h, Whh) + bhh
    r = torch.sigmoid(x_proj[..., :H] + hp[..., :H])
    z = torch.sigmoid(x_proj[..., H:2 * H] + hp[..., H:2 * H])
    n = torch.tanh(x_proj[..., 2 * H:] + r * hp[..., 2 * H:])
    return (1.0 - z) * n + z * h


def lsthm_gates(sums, c):
    """The LSTHM gates in the order f, i, o, c-hat: ``(c_t, h_t)``."""
    H = c.shape[-1]
    f, i, o = (torch.sigmoid(sums[..., k * H:(k + 1) * H]) for k in range(3))
    c = f * c + i * torch.tanh(sums[..., 3 * H:])
    return c, torch.tanh(c) * o


def rank1_attention(x1, x2, wq, wk):
    """The per-step cross attention with rank-1 logits, both directions:
    ``alpha = x1 * (x2 . wq) / sqrt(D)``, logits ``alpha[i] * wk[k]``,
    ``z[i] = sum_k softmax_k(logits)[i, k] * x2[k]``. x1, x2 ``[2, B, D]``,
    wq, wk ``[2, 1, D]``. The row max is exact (``alpha * max wk`` or
    ``alpha * min wk`` by the sign of alpha) and held out of the gradient."""
    D = x1.shape[-1]
    s = (x2 * wq).sum(-1, keepdim=True) / D ** 0.5
    alpha = x1 * s
    m = torch.where(alpha > 0, alpha * wk.amax(-1, keepdim=True),
                    alpha * wk.amin(-1, keepdim=True)).detach()
    e = torch.exp(alpha[..., :, None] * wk[..., None, :] - m[..., None])
    return (e * x2[..., None, :]).sum(-1) / e.sum(-1)


def cross_attention_seq(P, name, x1, x2):
    """``CrossAttention2`` on time-major ``[L, B, .]``: queries from x1, keys
    and values from x2, softmax over the whole padded sequence."""
    x1b, x2b = x1.transpose(0, 1), x2.transpose(0, 1)
    q = torch.matmul(x1b, P[f"{name}.Wq"])
    k = torch.matmul(x2b, P[f"{name}.Wk"])
    v = torch.matmul(x2b, P[f"{name}.Wv"])
    dk = P[f"{name}.Wq"].shape[1]
    attn = torch.softmax(torch.einsum("bqd,bkd->bqk", q / dk ** 0.5, k), dim=-1)
    return torch.einsum("bqk,bkd->bqd", attn, v).transpose(0, 1)


def text_mean(batch, key_prefix="r", views=4):
    """The four RoBERTa views averaged, ``((r1 + r2) + r3) + r4) / 4``."""
    out = batch[f"{key_prefix}1"]
    for k in range(2, views + 1):
        out = out + batch[f"{key_prefix}{k}"]
    return out / views


def marn1_inputs(batch, config):
    """MARN1's input x ``[L, B, .]`` in float64: the mean of the text views,
    then the audio."""
    return torch.cat([text_mean({k: batch[k].double() for k in batch if k.startswith("r")},
                                views=config["text_views"]),
                      batch["acouf"].double()], -1)


def reference_input(cell, batch):
    """The reference's input x ``[L, B, .]`` of one batch (the tensors of
    ``generate.collate``'s fields, on the reference's device), float64: the
    cell's reference module's ``inputs(batch, config)``."""
    return cell.reference.inputs(batch, cell.config)


def masked_loss(logp, labels, umask):
    """The reference's ``MaskedLoss`` with CrossEntropy on the model's
    log-probabilities: rows zeroed where umask is 0, log-softmax taken a
    second time, the summed row loss over the mask's sum. logp ``[B*L, C]``
    batch-major, labels and umask ``[B, L]``."""
    mask = umask.reshape(-1, 1)
    logq = torch.log_softmax(logp * mask, dim=-1)
    rows = -logq.gather(1, labels.reshape(-1, 1).long())[:, 0]
    return rows.sum() / umask.sum()


def adam_step(params, grads, state, lr, weight_decay, betas=BETAS, eps=EPS):
    """One step of ``torch.optim.Adam`` with coupled decay (added to the
    gradient before the moments), in place on ``params`` (name -> tensor).
    A parameter whose gradient is None (never reached by the forward) is
    skipped and keeps no state; one whose gradient is all zero keeps its
    value while its moments advance (the reference's dead-parameter rule)."""
    b1, b2 = betas
    for name, g in grads.items():
        if g is None:
            continue
        p = params[name]
        frozen = not bool(g.ne(0).any())
        g = g + weight_decay * p
        st = state.setdefault(name, {"step": 0, "m": torch.zeros_like(p),
                                     "v": torch.zeros_like(p)})
        st["step"] += 1
        st["m"] = b1 * st["m"] + (1 - b1) * g
        st["v"] = b2 * st["v"] + (1 - b2) * g * g
        bc1, bc2 = 1 - b1 ** st["step"], 1 - b2 ** st["step"]
        denom = st["v"].sqrt() / math.sqrt(bc2) + eps
        if not frozen:
            params[name] = p - (lr / bc1) * st["m"] / denom
