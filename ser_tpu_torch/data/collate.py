"""Batch collation: padded, time-major (counterpart of
``ser_tpu/data/collate.py``, its numpy path).

Fields 0-6 (r1..r4, visuf, acouf, qmask) are padded time-major ``[L, B, .]``,
umask and label batch-first ``[B, L]``. L is rounded up to a bucket and the
batch padded to a fixed size; padded rows carry umask 0. The optional raw
audio is padded to ``[L, B, T]`` with T the batch's longest waveform rounded
up to 2048 samples, beside the per-dialogue sample counts ``wav_len [B]``.
"""

from __future__ import annotations

import numpy as np

DEFAULT_BUCKETS = (8, 16, 24, 32, 48, 64, 96, 128, 160, 192, 256)
WAV_BUCKET = 2048


def bucket_length(n: int, buckets=DEFAULT_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    return n


def collate(items, pad_length=None, pad_batch=None):
    """Collate dataset items into one padded batch dict: r1..r4, visuf,
    acouf, qmask ``[L, B, .]``, umask and label ``[B, L]``, vid (padded with
    None) and, when the items carry it, wav ``[L, B, T]`` and wav_len ``[B]``.
    ``pad_length`` pads L (None: the bucket of the batch max);
    ``pad_batch`` pads B with all-masked rows (None: ``len(items)``)."""
    n = len(items)
    max_len = max(it[8].shape[0] for it in items)
    L = pad_length if pad_length is not None else bucket_length(max_len)
    if L < max_len:
        raise ValueError(f"pad_length {L} < batch max length {max_len}")
    B = pad_batch if pad_batch is not None else n
    if B < n:
        raise ValueError(f"pad_batch {B} < batch size {n}")

    out = {}
    for i, name in enumerate(["r1", "r2", "r3", "r4", "visuf", "acouf", "qmask"]):
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
    out["vid"] = [it[9] for it in items] + [None] * (B - n)
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
