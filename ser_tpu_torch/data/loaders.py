"""Epoch loaders with the reference's sampler semantics (counterpart of
``ser_tpu/data/loaders.py``).

The valid split is the first ``valid`` fraction of the train set's
unshuffled index order; train and valid iterate shuffled, test in order.
Loaders yield padded batch dicts (``collate.py``), assembled on the host by
the C collate; ``PrefetchLoader`` keeps a few ready in a background thread while
the device computes. ``advance_epochs`` burns the shuffle randomness of
finished epochs, so a resumed run sees the batch order of the run that was
never stopped.

Data parallelism: with ``process_count > 1`` every process builds the same
global batch (the same seed gives the same shuffle, composition and length
bucket as one process) and keeps its contiguous ``batch_size /
process_count`` rows; the global ``umask`` and ``label`` ride along as
``umask_global`` and ``label_global`` for the loss's normalizer and the
eval's metrics.
"""

from __future__ import annotations

import os
import queue
import threading

import numpy as np

from ser_tpu_torch.data.collate import DEFAULT_BUCKETS, collate
from ser_tpu_torch.data.datasets import IEMOCAPDataset, MELDDataset
from ser_tpu_torch.parallel.mesh import local_batch_slice


class EpochLoader:
    """Iterates a dataset subset in batches, reshuffling each epoch; every
    batch is padded to ``batch_size`` rows and L to its bucket in
    ``buckets``. With
    ``process_count > 1`` a batch is this process's rows of the global one
    (``_local_rows``)."""

    def __init__(self, dataset, indices, batch_size, shuffle=True, seed=0,
                 process_index=0, process_count=1, buckets=DEFAULT_BUCKETS):
        self.dataset = dataset
        self.indices = np.asarray(indices, dtype=np.int64)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.rows = local_batch_slice(process_index, process_count)(batch_size)
        self.process_count = process_count
        self.buckets = buckets

    def __len__(self):
        return int(np.ceil(len(self.indices) / self.batch_size))

    def num_examples(self):
        return len(self.indices)

    def advance_epochs(self, n):
        """Draw ``n`` epochs' shuffles without loading data: each
        ``__iter__`` takes exactly one ``rng.shuffle`` of the indices."""
        for _ in range(int(n)):
            if self.shuffle:
                self.rng.shuffle(self.indices.copy())

    def __iter__(self):
        order = self.indices.copy()
        if self.shuffle:
            self.rng.shuffle(order)
        for start in range(0, len(order), self.batch_size):
            items = [self.dataset[int(i)]
                     for i in order[start:start + self.batch_size]]
            batch = collate(items, pad_batch=self.batch_size, buckets=self.buckets)
            yield self._local_rows(batch) if self.process_count > 1 else batch

    def _local_rows(self, batch):
        """This process's contiguous rows of a global batch, with the global
        ``umask`` and ``label`` kept as ``umask_global`` and
        ``label_global``."""
        out = {"umask_global": batch["umask"], "label_global": batch["label"]}
        for name, v in batch.items():
            if name in ("vid", "umask", "label", "wav_len"):  # batch-major
                out[name] = v[self.rows]
            else:  # time-major [L, B, ...]
                out[name] = v[:, self.rows]
        return out


class PrefetchLoader:
    """Overlaps host batch assembly with device compute: a background thread
    keeps up to ``depth`` collated batches ready (the reference gets the same
    from ``DataLoader(num_workers=2)``). An exception in the thread is raised
    in the consumer; a consumer that stops early leaves no thread blocked."""

    def __init__(self, loader, depth: int = 2):
        self.loader = loader
        self.depth = depth

    def __len__(self):
        return len(self.loader)

    def num_examples(self):
        return self.loader.num_examples()

    def advance_epochs(self, n):
        self.loader.advance_epochs(n)

    def __iter__(self):
        q = queue.Queue(maxsize=self.depth)
        done = object()
        abandoned = threading.Event()

        def put(item) -> bool:
            """Queue ``item`` unless the consumer has gone; True if queued."""
            while not abandoned.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for batch in self.loader:
                    if not put(batch):
                        return
                put(done)
            except BaseException as e:  # forwarded to the consumer, not hidden
                put((done, e))

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    break
                if isinstance(item, tuple) and len(item) == 2 and item[0] is done:
                    raise item[1]
                yield item
            t.join()
        finally:
            abandoned.set()


def get_train_valid_indices(n, valid=0.1):
    """First ``valid`` fraction of index order -> valid, the rest -> train."""
    idx = np.arange(n)
    split = int(valid * n)
    return idx[split:], idx[:split]


def get_loaders(feature_path, dataset="IEMOCAP", batch_size=32, valid=0.1,
                n_classes=3, seed=0, roberta_path=None, wav_path=None,
                process_index=0, process_count=1):
    """``(train, valid, test)`` loaders. ``n_classes`` (3 or 7) picks MELD's
    label set and is not read for IEMOCAP. ``wav_path`` is an optional
    raw-audio pickle for the MFCC front end; ``"auto"`` takes
    ``IEMOCAP_wav.pkl`` beside the main pickle. MELD has no raw audio: its
    loaders ignore ``wav_path``, as the JAX package's do. ``process_index``
    and ``process_count`` go to every loader (data parallelism)."""
    if dataset == "IEMOCAP":
        path = feature_path + "IEMOCAP_features/IEMOCAP_features_raw.pkl"
        if wav_path == "auto":
            wav_path = os.path.join(os.path.dirname(path), "IEMOCAP_wav.pkl")
        trainset = IEMOCAPDataset(path=path, roberta_path=roberta_path,
                                  wav_path=wav_path)
        testset = IEMOCAPDataset(path=path, train=False,
                                 roberta_path=roberta_path, wav_path=wav_path)
    elif dataset == "MELD":
        path = feature_path + "MELD_features/MELD_features_raw.pkl"
        trainset = MELDDataset(path=path, n_classes=n_classes,
                               roberta_path=roberta_path)
        testset = MELDDataset(path=path, n_classes=n_classes, train=False,
                              roberta_path=roberta_path)
    else:
        raise ValueError(f"unknown dataset: {dataset}")
    train_idx, valid_idx = get_train_valid_indices(len(trainset), valid)
    proc = dict(process_index=process_index, process_count=process_count)
    return (
        EpochLoader(trainset, train_idx, batch_size, shuffle=True, seed=seed, **proc),
        EpochLoader(trainset, valid_idx, batch_size, shuffle=True,
                    seed=seed + 1, **proc),
        EpochLoader(testset, np.arange(len(testset)), batch_size,
                    shuffle=False, seed=seed + 2, **proc),
    )
