"""The one traffic generator: dialogues and batches from a traffic file's
parameters, a configuration's widths and the run's seed.

A split is a fixed set of dialogue lengths, the same for every seed (drawn
once from the traffic file's own length seed, ``split_lengths``), with
features that the run's seed draws; an epoch's batches are cut from
shuffles that the length seed fixes too. So every seed does the same
work. Each utterance has four RoBERTa views and an audio
vector, N(0, 1), a speaker among the configuration's parties and a label
among its classes, and, where the configuration gives ``visual_width``, a
visual vector, N(0, 1), drawn after all of those (so a configuration
without it draws what it drew before the key existed). A batch is the
program's collated numpy layout: r1..r4, acouf, visuf (with a visual
vector) and qmask time-major ``[L, B, .]``, umask and label ``[B, L]``,
padded with zeros to its own longest dialogue.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def split_lengths(spec: dict) -> np.ndarray:
    """The split's dialogue lengths, ``dialogues`` of them summing to
    ``utterances``, each within [min_len, max_len], drawn from
    ``length_seed`` by the traffic's ``length_draw``:

    - ``scaled``: ``integers(length_low, length_high)`` draws scaled to the
      total, as the program's ``iemocap_eval_batch`` draws them;
    - ``tail``: ``length_low + (max_len - length_low) * u ** g`` over
      uniform draws ``u``, the largest set to 1 (so the longest dialogue is
      ``max_len``), with the power ``g`` that makes them sum to the total:
      many short dialogues and a tail of long ones up to ``max_len``.

    Each is rounded down, and the largest remainders take one more."""
    n, total = spec["dialogues"], spec["utterances"]
    rng = np.random.default_rng(spec["length_seed"])
    if spec["length_draw"] == "scaled":
        raw = rng.integers(spec["length_low"], spec["length_high"], size=n)
        exact = raw * (total / raw.sum())
    elif spec["length_draw"] == "tail":
        u = rng.random(n)
        u[np.argmax(u)] = 1.0
        low, span = spec["length_low"], spec["max_len"] - spec["length_low"]
        a, b = 1e-3, 1e3  # the sum falls as the power grows
        for _ in range(200):
            g = (a * b) ** 0.5
            a, b = (g, b) if (low + span * u ** g).sum() > total else (a, g)
        exact = low + span * u ** g
    else:
        raise ValueError(f"no length draw {spec['length_draw']!r}")
    lengths = np.floor(exact).astype(np.int64)
    order = np.argsort(-(exact - lengths), kind="stable")
    lengths[order[:total - lengths.sum()]] += 1
    if lengths.sum() != total or lengths.min() < spec["min_len"] or lengths.max() > spec["max_len"]:
        raise ValueError(f"no {n} dialogues of {spec['min_len']}-{spec['max_len']} "
                         f"utterances sum to {total} from these draws")
    return lengths


@dataclass
class Split:
    """Dialogues stored back to back: ``text [views, U, width]``, ``audio
    [U, width]``, ``speaker [U]``, ``label [U]``, ``visual [U, width]`` or
    None; dialogue d spans ``offsets[d]:offsets[d] + lengths[d]``."""

    lengths: np.ndarray
    offsets: np.ndarray
    text: np.ndarray
    audio: np.ndarray
    speaker: np.ndarray
    label: np.ndarray
    parties: int
    visual: np.ndarray | None = None

    @property
    def utterances(self) -> int:
        return int(self.lengths.sum())


def make_split(lengths, config: dict, rng: np.random.Generator) -> Split:
    """A split of dialogues of ``lengths`` with features drawn from ``rng``."""
    lengths = np.asarray(lengths, dtype=np.int64)
    U = int(lengths.sum())
    text = rng.standard_normal((config["text_views"], U, config["text_width"]),
                               dtype=np.float32)
    audio = rng.standard_normal((U, config["audio_width"]), dtype=np.float32)
    speaker = rng.integers(0, config["parties"], size=U)
    label = rng.integers(0, config["classes"], size=U).astype(np.int32)
    visual = (rng.standard_normal((U, config["visual_width"]), dtype=np.float32)
              if "visual_width" in config else None)
    offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    return Split(lengths, offsets, text, audio, speaker, label, config["parties"], visual)


def collate(split: Split, idx) -> dict:
    """The batch of dialogues ``idx``, padded to the longest of them."""
    idx = np.asarray(idx)
    lens = split.lengths[idx]
    L, B = int(lens.max()), len(idx)
    views = split.text.shape[0]
    batch = {f"r{k + 1}": np.zeros((L, B, split.text.shape[2]), np.float32)
             for k in range(views)}
    batch["acouf"] = np.zeros((L, B, split.audio.shape[1]), np.float32)
    if split.visual is not None:
        batch["visuf"] = np.zeros((L, B, split.visual.shape[1]), np.float32)
    batch["qmask"] = np.zeros((L, B, split.parties), np.float32)
    batch["umask"] = np.zeros((B, L), np.float32)
    batch["label"] = np.zeros((B, L), np.int32)
    for b, (d, n) in enumerate(zip(idx, lens)):
        s = slice(split.offsets[d], split.offsets[d] + n)
        for k in range(views):
            batch[f"r{k + 1}"][:n, b] = split.text[k, s]
        batch["acouf"][:n, b] = split.audio[s]
        if split.visual is not None:
            batch["visuf"][:n, b] = split.visual[s]
        batch["qmask"][np.arange(n), b, split.speaker[s]] = 1.0
        batch["umask"][b, :n] = 1.0
        batch["label"][b, :n] = split.label[s]
    return batch


def shape_of(batch) -> tuple[int, int]:
    """``(L, B)`` of a collated batch."""
    B, L = batch["umask"].shape
    return L, B


def valid_utterances(batch) -> int:
    return int(batch["umask"].sum())


def shuffles(dialogues: int, batch_size: int, count: int, rng) -> list[list[np.ndarray]]:
    """``count`` shuffles of ``dialogues`` dialogues by ``rng``, each cut
    into batches of ``batch_size`` (the last one smaller): index arrays."""
    out = []
    for _ in range(count):
        order = rng.permutation(dialogues)
        out.append([order[i:i + batch_size] for i in range(0, dialogues, batch_size)])
    return out


def epochs(split: Split, groups) -> list[list[dict]]:
    """The collated batches of each shuffle of ``groups`` (``shuffles``)."""
    return [[collate(split, idx) for idx in epoch] for epoch in groups]


def requests(lengths, config: dict, count: int, rng) -> list[dict]:
    """``count`` requests, each one whole split of ``lengths`` in an order and
    with features of its own, as one batch."""
    out = []
    for _ in range(count):
        split = make_split(rng.permutation(lengths), config, rng)
        out.append(collate(split, np.arange(len(lengths))))
    return out
