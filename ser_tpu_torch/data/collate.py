"""Batch collation: padded, time-major (counterpart of
``ser_tpu/data/collate.py``).

Fields 0-6 (r1..r4, visuf, acouf, qmask) are padded time-major ``[L, B, .]``,
umask and label batch-first ``[B, L]``. L is rounded up to a bucket and the
batch padded to a fixed size; padded rows carry umask 0. The optional raw
audio is padded to ``[L, B, T]`` with T the batch's longest waveform rounded
up to 2048 samples, beside the per-dialogue sample counts ``wav_len [B]``.

``collate`` scatters the fields through the C path (``ser_tpu_torch/native``);
``collate_ref`` is the plain numpy version of the same function, which the
tests hold it to and nothing on the main path calls.
"""

from __future__ import annotations

import numpy as np

from ser_tpu_torch import native

DEFAULT_BUCKETS = (8, 16, 24, 32, 48, 64, 96, 128, 160, 192, 256)
WAV_BUCKET = 2048
FIELDS = ("r1", "r2", "r3", "r4", "visuf", "acouf", "qmask")


def bucket_length(n: int, buckets=DEFAULT_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    return n


def _shape(items, pad_length, pad_batch, buckets):
    """``(L, B)`` of the padded batch."""
    n = len(items)
    max_len = max(it[8].shape[0] for it in items)
    L = pad_length if pad_length is not None else bucket_length(max_len, buckets)
    if L < max_len:
        raise ValueError(f"pad_length {L} < batch max length {max_len}")
    B = pad_batch if pad_batch is not None else n
    if B < n:
        raise ValueError(f"pad_batch {B} < batch size {n}")
    return L, B


def _finish(out, items, L, B):
    """The ids (padded with None) and, when the items carry it, the raw
    audio."""
    out["vid"] = [it[9] for it in items] + [None] * (B - len(items))
    if len(items[0]) > 10:
        T = max(it[10].shape[-1] for it in items)
        T = -(-T // WAV_BUCKET) * WAV_BUCKET
        wav = np.zeros((L, B, T), dtype=np.float32)
        wav_len = np.zeros((B,), dtype=np.int32)
        for b, it in enumerate(items):
            wav[:it[10].shape[0], b, :it[10].shape[-1]] = it[10]
            wav_len[b] = it[10].shape[-1]
        out["wav"] = wav
        out["wav_len"] = wav_len
    return out


def collate(items, pad_length=None, pad_batch=None, buckets=DEFAULT_BUCKETS):
    """Collate dataset items into one padded batch dict: r1..r4, visuf,
    acouf, qmask ``[L, B, .]``, umask and label ``[B, L]``, vid (padded with
    None) and, when the items carry it, wav ``[L, B, T]`` and wav_len ``[B]``.
    ``pad_length`` pads L (None: the bucket of the batch max in
    ``buckets``); ``pad_batch`` pads B with all-masked rows (None:
    ``len(items)``). The fields go through the C scatter."""
    L, B = _shape(items, pad_length, pad_batch, buckets)
    out = {name: native.pad_time_major([it[i] for it in items], L, B)
           for i, name in enumerate(FIELDS)}
    out["umask"] = native.pad_batch_first([it[7] for it in items], L, B, np.float32)
    out["label"] = native.pad_batch_first([it[8] for it in items], L, B, np.int32)
    return _finish(out, items, L, B)


def collate_ref(items, pad_length=None, pad_batch=None, buckets=DEFAULT_BUCKETS):
    """``collate`` in numpy alone (the plain version)."""
    L, B = _shape(items, pad_length, pad_batch, buckets)
    out = {}
    for i, name in enumerate(FIELDS):
        arr = np.zeros((L, B, items[0][i].shape[-1]), dtype=np.float32)
        for b, it in enumerate(items):
            arr[:it[i].shape[0], b] = it[i]
        out[name] = arr
    umask = np.zeros((B, L), dtype=np.float32)
    label = np.zeros((B, L), dtype=np.int32)
    for b, it in enumerate(items):
        t = it[8].shape[0]
        umask[b, :t] = it[7]
        label[b, :t] = it[8]
    out["umask"] = umask
    out["label"] = label
    return _finish(out, items, L, B)
