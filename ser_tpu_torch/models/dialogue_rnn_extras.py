"""The DialogueRNN suite's extra models (counterpart of
``ser_tpu/models/dialogue_rnn_extras.py``; ref ``model/DialogueRNN.py:279-705``).

Six modules beside the registry's ``BiModel``, which no trainer and no CLI
uses, in either package: the unidirectional ``DialogueRNNModel`` (the
reference's ``Model``, whose ``forward`` crashes as shipped; this one, as
the JAX module, returns the working semantics), the regression head
``AVECModel``, the text CNN ``CNNFeatureExtractor``, ``DailyDialogueModel``
(the CNN's features through a bidirectional DialogueRNN) and the three-turn
``E2EModel`` and ``BiE2EModel`` (each turn's words through ``TorchGRU``,
the turns' last states through a DialogueRNN, one label for turn 3).

Each keeps the JAX module's structure, defaults, dropout placement and
returns, and the reference's keys (``dialog_rnn``, ``matchatt.transform``,
``linear1``, ``smax_fc``, ``cnn_feat_extractor.convs.{0,1,2}``,
``turn_rnn``, ``embedding.weight``; ``compat/from_jax.py`` maps them). The
DialogueRNN defaults here are 'simple' context attention and no listener
state; the cells' dropout is ``dropout_rec``. Inputs are time-major: U
``[L, B, D_m]``, qmask ``[L, B, P]``, umask ``[B, L]``, token ids ``[L, B,
W]`` or a turn's ``[W, B]``. In train mode every dropout draws from
``generator``, which must be given. The loops are eager ops (no kernel of
the port); the GRU is cuDNN's on the card.
"""

from __future__ import annotations

import torch
from torch import nn

from ser_tpu_torch.models.dialogue_rnn import (
    DialogueRNN,
    MatchingAttention,
    bidirectional,
    cell_dropout,
    matching_attention_general2,
)
from ser_tpu_torch.ops.init import uniform_
from ser_tpu_torch.ops.layers import Dropout, TorchLinear, train_generator
from ser_tpu_torch.ops.masking import reverse_seq
from ser_tpu_torch.ops.rnn import TorchGRU

# E2E's speakers: turns 1 and 3 by party 0, turn 2 by party 1
_TURN_SPEAKERS = ((1.0, 0.0), (0.0, 1.0), (1.0, 0.0))


class DialogueRNNModel(nn.Module):
    """Unidirectional ``Model`` (ref ``DialogueRNN.py:432-480``): the
    emotions (dropout + 0.15), with ``att2`` pooled by 'general2' matching
    attention over themselves, ``linear1``, ReLU, dropout, ``smax_fc``.
    Returns log-probs ``[L, B, n_classes]``."""

    def __init__(self, D_m: int, D_g: int, D_p: int, D_e: int, D_h: int, n_classes: int = 7,
                 listener_state: bool = False, context_attention: str = "simple",
                 dropout_rec: float = 0.5, dropout: float = 0.5, *,
                 generator: torch.Generator):
        super().__init__()
        g = generator
        self.dropout_rate = dropout_rec
        self.dialog_rnn = DialogueRNN(D_m, D_g, D_p, D_e, listener_state, context_attention,
                                      generator=g)
        self.dropout_rec = Dropout(dropout + 0.15)
        self.matchatt = MatchingAttention(D_e, D_e, True, generator=g)
        self.linear1 = TorchLinear(D_e, D_h, generator=g)
        self.dropout = Dropout(dropout)
        self.smax_fc = TorchLinear(D_h, n_classes, generator=g)

    def forward(self, U, qmask, umask=None, att2: bool = False,
                generator: torch.Generator | None = None):
        g = train_generator(self, generator)
        emotions = self.dropout_rec(
            self.dialog_rnn(U, qmask, cell_dropout(self.dropout_rate, g))[0], g)
        if att2:
            mask = umask if umask is not None else U.new_ones(U.shape[1], U.shape[0])
            emotions = matching_attention_general2(emotions, emotions, mask,
                                                   self.matchatt.transform)[0]
        hidden = self.dropout(torch.relu(self.linear1(emotions)), g)
        return torch.log_softmax(self.smax_fc(hidden), dim=2)


class AVECModel(nn.Module):
    """Regression head for AVEC attributes (ref ``DialogueRNN.py:482-515``):
    the emotions (dropout), ``linear``, tanh, dropout, ``smax_fc`` to one
    value. Returns ``[B·L]`` predictions, batch-major. ``attr`` is the
    reference's and unused, as in the JAX module."""

    def __init__(self, D_m: int, D_g: int, D_p: int, D_e: int, D_h: int, attr: int = 1,
                 listener_state: bool = False, context_attention: str = "simple",
                 dropout_rec: float = 0.5, dropout: float = 0.5, *,
                 generator: torch.Generator):
        super().__init__()
        g = generator
        self.dropout_rate = dropout_rec
        self.dialog_rnn = DialogueRNN(D_m, D_g, D_p, D_e, listener_state, context_attention,
                                      generator=g)
        self.dropout_rec = Dropout(dropout)
        self.linear = TorchLinear(D_e, D_h, generator=g)
        self.dropout = Dropout(dropout)
        self.smax_fc = TorchLinear(D_h, 1, generator=g)

    def forward(self, U, qmask, generator: torch.Generator | None = None):
        g = train_generator(self, generator)
        emotions = self.dropout_rec(
            self.dialog_rnn(U, qmask, cell_dropout(self.dropout_rate, g))[0], g)
        hidden = self.dropout(torch.tanh(self.linear(emotions)), g)
        return self.smax_fc(hidden)[..., 0].transpose(0, 1).reshape(-1)


class CNNFeatureExtractor(nn.Module):
    """Text CNN over token ids (ref ``DialogueRNN.py:564-601``): an
    embedding table N(0, 1), ``Conv1d(embedding_dim, filters, K)`` for each
    K of ``kernel_sizes``, ReLU, a max over the ``W - K + 1`` windows,
    dropout, ``fc``, ReLU; the features of padded utterances are zeroed by
    ``umask``. ``forward(x [L, B, W], umask [B, L])`` returns ``[L, B,
    output_size]``; W below the widest kernel raises ``ValueError``."""

    def __init__(self, vocab_size: int, embedding_dim: int = 300, output_size: int = 100,
                 filters: int = 50, kernel_sizes=(3, 4, 5), dropout: float = 0.5, *,
                 generator: torch.Generator):
        super().__init__()
        g = generator
        self.embedding = nn.Embedding(vocab_size, embedding_dim, _weight=torch.randn(
            vocab_size, embedding_dim, generator=g))
        self.convs = nn.ModuleList()
        for K in kernel_sizes:
            conv = nn.Conv1d(embedding_dim, filters, K, device="meta").to_empty(device="cpu")
            for p in conv.parameters():  # torch's default bounds, 1/sqrt(E·K)
                uniform_(p, (embedding_dim * K) ** -0.5, g)
            self.convs.append(conv)
        self.dropout = Dropout(dropout)
        self.fc = TorchLinear(len(kernel_sizes) * filters, output_size, generator=g)

    def forward(self, x, umask, generator: torch.Generator | None = None):
        L, B, W = x.shape
        widest = max(c.kernel_size[0] for c in self.convs)
        if W < widest:
            raise ValueError(f"CNNFeatureExtractor takes at least {widest} tokens an "
                             f"utterance (its widest kernel); got {W}")
        g = train_generator(self, generator)
        emb = self.embedding(x.reshape(-1, W)).transpose(1, 2)  # [L·B, E, W]
        pooled = torch.cat([torch.relu(conv(emb)).amax(dim=2) for conv in self.convs], 1)
        pooled = self.dropout(pooled, g)
        features = torch.relu(self.fc(pooled)).reshape(L, B, -1)
        return features * umask.transpose(0, 1)[:, :, None]


class DailyDialogueModel(nn.Module):
    """CNN features through a bidirectional DialogueRNN (ref
    ``DialogueRNN.py:603-685``): each direction's emotions take
    ``dropout_rec`` once, then with ``att2`` 'general2' matching attention,
    ``linear``, ReLU, dropout, ``smax_fc``. ``forward(input_seq [L, B, W],
    qmask, umask)`` returns ``(log_prob [L, B, n_classes], alpha [L, B, L]
    or None, alpha_f, alpha_b)``. The CNN takes its own defaults, so D_m is
    its output width, 100."""

    def __init__(self, D_m: int, D_g: int, D_p: int, D_e: int, D_h: int, vocab_size: int,
                 n_classes: int = 7, listener_state: bool = False,
                 context_attention: str = "simple", dropout_rec: float = 0.5,
                 dropout: float = 0.5, att2: bool = True, *, generator: torch.Generator):
        super().__init__()
        g = generator
        self.att2 = att2
        self.dropout_rate = dropout_rec
        self.cnn_feat_extractor = CNNFeatureExtractor(vocab_size, generator=g)
        self.dialog_rnn_f = DialogueRNN(D_m, D_g, D_p, D_e, listener_state, context_attention,
                                        generator=g)
        self.dialog_rnn_r = DialogueRNN(D_m, D_g, D_p, D_e, listener_state, context_attention,
                                        generator=g)
        self.dropout_rec = Dropout(dropout_rec)
        self.matchatt = MatchingAttention(2 * D_e, 2 * D_e, True, generator=g)
        self.linear = TorchLinear(2 * D_e, 2 * D_h, generator=g)
        self.dropout = Dropout(dropout)
        self.smax_fc = TorchLinear(2 * D_h, n_classes, generator=g)

    def forward(self, input_seq, qmask, umask, generator: torch.Generator | None = None):
        g = train_generator(self, generator)
        U = self.cnn_feat_extractor(input_seq, umask, g)
        es_f, es_b, alpha_f, alpha_b = bidirectional(
            self.dialog_rnn_f, self.dialog_rnn_r, U, qmask, umask,
            cell_dropout(self.dropout_rate, g))
        emotions = torch.cat([self.dropout_rec(es_f, g),
                              self.dropout_rec(reverse_seq(es_b, umask), g)], -1)
        alpha = None
        if self.att2:
            emotions, alpha = matching_attention_general2(emotions, emotions, umask,
                                                          self.matchatt.transform)
        hidden = self.dropout(torch.relu(self.linear(emotions)), g)
        return torch.log_softmax(self.smax_fc(hidden), dim=2), alpha, alpha_f, alpha_b


def _turns(turn_rnn, tables, turns):
    """U ``[3, B, D_m]``: each turn's ``[W, B]`` token ids looked up in
    ``tables`` and run through ``turn_rnn``, its last state kept; and the
    fixed speaker mask ``[3, B, 2]``."""
    U = torch.stack([turn_rnn(tables[t])[1] for t in turns])
    qmask = U.new_tensor(_TURN_SPEAKERS)[:, None, :].expand(3, U.shape[1], 2)
    return U, qmask


class E2EModel(nn.Module):
    """Three-turn end-to-end model over word embeddings (ref
    ``DialogueRNN.py:372-431``): the turns through ``turn_rnn`` (a GRU,
    D_emb -> D_m), a unidirectional DialogueRNN over the three, the
    emotions (dropout + 0.15), with ``att2`` turn 3's emotion attending
    over all three ('general2'), ``linear1``, ReLU, dropout, ``smax_fc``.
    ``forward(turn1, turn2, turn3, word_embeddings [V, D_emb])`` returns
    log-probs ``[B, n_classes]``; the table is an input, not a parameter."""

    def __init__(self, D_emb: int, D_m: int, D_g: int, D_p: int, D_e: int, D_h: int,
                 n_classes: int = 7, listener_state: bool = False,
                 context_attention: str = "simple", dropout_rec: float = 0.5,
                 dropout: float = 0.5, *, generator: torch.Generator):
        super().__init__()
        g = generator
        self.dropout_rate = dropout_rec
        self.turn_rnn = TorchGRU(D_emb, D_m, generator=g)
        self.dialog_rnn = DialogueRNN(D_m, D_g, D_p, D_e, listener_state, context_attention,
                                      generator=g)
        self.dropout_rec = Dropout(dropout + 0.15)
        self.matchatt = MatchingAttention(D_e, D_e, True, generator=g)
        self.linear1 = TorchLinear(D_e, D_h, generator=g)
        self.dropout = Dropout(dropout)
        self.smax_fc = TorchLinear(D_h, n_classes, generator=g)

    def forward(self, turn1, turn2, turn3, word_embeddings, att2: bool = False,
                generator: torch.Generator | None = None):
        g = train_generator(self, generator)
        U, qmask = _turns(self.turn_rnn, word_embeddings, (turn1, turn2, turn3))
        emotions = self.dropout_rec(
            self.dialog_rnn(U, qmask, cell_dropout(self.dropout_rate, g))[0], g)
        if att2:
            last = matching_attention_general2(emotions, emotions[-1:], U.new_ones(U.shape[1], 3),
                                               self.matchatt.transform)[0][0]
        else:
            last = emotions[-1]
        hidden = self.dropout(torch.relu(self.linear1(last)), g)
        return torch.log_softmax(self.smax_fc(hidden), dim=-1)


class BiE2EModel(nn.Module):
    """Bidirectional E2E (ref ``DialogueRNN.py:279-370``) with a trainable
    embedding table N(0, 1): the turns through ``turn_rnn``, both
    directions of a DialogueRNN, ``dropout`` on the forward emotions and
    again on the concatenation, with ``att2`` 'general2' attention from
    turn 3, ``linear1``, ReLU, ``smax_fc`` (no dropout on the hidden
    layer). ``forward(turn1, turn2, turn3)`` returns log-probs ``[B,
    n_classes]``."""

    def __init__(self, D_emb: int, D_m: int, D_g: int, D_p: int, D_e: int, D_h: int,
                 vocab_size: int, n_classes: int = 7, listener_state: bool = False,
                 context_attention: str = "simple", dropout_rec: float = 0.5,
                 dropout: float = 0.5, *, generator: torch.Generator):
        super().__init__()
        g = generator
        self.dropout_rate = dropout_rec
        self.embedding = nn.Embedding(vocab_size, D_emb, _weight=torch.randn(
            vocab_size, D_emb, generator=g))
        self.turn_rnn = TorchGRU(D_emb, D_m, generator=g)
        self.dialog_rnn_f = DialogueRNN(D_m, D_g, D_p, D_e, listener_state, context_attention,
                                        generator=g)
        self.dialog_rnn_r = DialogueRNN(D_m, D_g, D_p, D_e, listener_state, context_attention,
                                        generator=g)
        self.dropout_rec = Dropout(dropout)
        self.matchatt = MatchingAttention(2 * D_e, 2 * D_e, True, generator=g)
        self.linear1 = TorchLinear(2 * D_e, D_h, generator=g)
        self.smax_fc = TorchLinear(D_h, n_classes, generator=g)

    def forward(self, turn1, turn2, turn3, att2: bool = False,
                generator: torch.Generator | None = None):
        g = train_generator(self, generator)
        U, qmask = _turns(self.turn_rnn, self.embedding.weight, (turn1, turn2, turn3))
        umask = U.new_ones(U.shape[1], 3)
        es_f, es_b, _, _ = bidirectional(self.dialog_rnn_f, self.dialog_rnn_r, U, qmask, umask,
                                         cell_dropout(self.dropout_rate, g))
        emotions = self.dropout_rec(
            torch.cat([self.dropout_rec(es_f, g), reverse_seq(es_b, umask)], -1), g)
        if att2:
            last = matching_attention_general2(emotions, emotions[-1:], umask,
                                               self.matchatt.transform)[0][0]
        else:
            last = emotions[-1]
        return torch.log_softmax(self.smax_fc(torch.relu(self.linear1(last))), dim=-1)
