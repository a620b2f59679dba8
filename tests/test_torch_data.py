"""The port's data pipeline and metrics on the CPU against the JAX package's.

The same seed must write the same pickles; ``collate`` must give equal
dicts, with ``wav`` and ``wav_len``; ``get_loaders`` must iterate the test
split in the same order with the same padded ``[L, B, T]``; the metrics must
give equal numbers.
"""

import pickle
import random

import numpy as np
import pytest
import torch

from ser_tpu.data.collate import bucket_length as jbucket_length
from ser_tpu.data.collate import collate as jcollate
from ser_tpu.data import loaders as jloaders
from ser_tpu.data import synthetic as jsynthetic
from ser_tpu.train import metrics as jmetrics
from ser_tpu_torch.data import collate as tcollate
from ser_tpu_torch.data import loaders as tloaders
from ser_tpu_torch.data import synthetic as tsynthetic
from ser_tpu_torch.data.datasets import IEMOCAPDataset
from ser_tpu_torch.train import metrics as tmetrics
from ser_tpu_torch.utils.seeding import seed_everything

SMALL = dict(n_train=5, n_test=3, min_len=4, max_len=12, seed=7, wav_len=1600)
PICKLES = ("IEMOCAP_features_raw.pkl", "iemocap_features_roberta.pkl",
           "IEMOCAP_wav.pkl")


def _assert_same(a, b, where):
    assert type(a) is type(b), where
    if isinstance(a, dict):
        assert list(a) == list(b), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, where


@pytest.fixture(scope="module")
def feature_paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("pickles")
    return (tsynthetic.generate_iemocap_pickles(str(d / "torch"), with_wav=True, **SMALL),
            jsynthetic.generate_iemocap_pickles(str(d / "jax"), with_wav=True, **SMALL))


@pytest.mark.parametrize("name", PICKLES)
def test_pickles_equal_the_jax_packages(feature_paths, name):
    loaded = []
    for path in feature_paths:
        with open(f"{path}IEMOCAP_features/{name}", "rb") as f:
            loaded.append(pickle.load(f))
    _assert_same(*loaded, name)


def test_collate_equals_the_jax_packages(feature_paths):
    ds = IEMOCAPDataset(f"{feature_paths[0]}IEMOCAP_features/IEMOCAP_features_raw.pkl",
                        wav_path=f"{feature_paths[0]}IEMOCAP_features/IEMOCAP_wav.pkl")
    items = [ds[i] for i in range(3)]
    items[1] = items[1][:10] + (items[1][10][:, :900],)  # a shorter dialogue
    for kw in ({}, {"pad_length": 24, "pad_batch": 5}):
        ours, theirs = tcollate.collate(items, **kw), jcollate(items, **kw)
        assert sorted(ours) == sorted(theirs)
        _assert_same(ours, theirs, str(kw))
    assert ours["wav"].shape == (24, 5, 2048)
    np.testing.assert_array_equal(ours["wav_len"], [1600, 900, 1600, 0, 0])
    assert tcollate.bucket_length(17) == jbucket_length(17) == 24
    with pytest.raises(ValueError, match="pad_length"):
        tcollate.collate(items, pad_length=2)


def test_test_loader_iterates_like_the_jax_packages(feature_paths):
    kw = dict(batch_size=2, valid=0.2, seed=3, wav_path="auto")
    ours = tloaders.get_loaders(feature_paths[0], **kw)
    theirs = jloaders.get_loaders(feature_paths[0], **kw)
    for o, t in zip(ours, theirs):
        assert len(o) == len(t) and o.num_examples() == t.num_examples()
    batches = list(zip(ours[2], theirs[2]))
    assert len(batches) == 2
    for o, t in batches:
        assert o["wav"].shape[1:] == (2, 2048)
        _assert_same(o, t, "test batch")
    with pytest.raises(ValueError, match="unknown dataset"):
        tloaders.get_loaders(feature_paths[0], dataset="CMU-MOSEI")


def test_train_valid_split_equals_the_jax_packages():
    for n, valid in ((10, 0.2), (7, 0.1), (1, 0.5)):
        for o, t in zip(tloaders.get_train_valid_indices(n, valid),
                        jloaders.get_train_valid_indices(n, valid)):
            np.testing.assert_array_equal(o, t)


def test_metrics_equal_the_jax_packages():
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 6, 200)
    preds = np.where(rng.random(200) < 0.6, labels, rng.integers(0, 6, 200))
    masks = (rng.random(200) < 0.8).astype(np.float32)
    for args in ((labels, preds, masks), (labels, preds, np.zeros(200))):
        assert tmetrics.weighted_accuracy(*args) == jmetrics.weighted_accuracy(*args)
        assert tmetrics.weighted_f1(*args) == jmetrics.weighted_f1(*args)


def test_seed_everything_seeds_every_generator():
    g = seed_everything(5)
    draws = (random.random(), np.random.random(), torch.rand(1).item(),
             torch.rand(1, generator=g).item())
    g = seed_everything(5)
    assert draws == (random.random(), np.random.random(), torch.rand(1).item(),
                     torch.rand(1, generator=g).item())


def test_prefetch_loader_yields_the_loaders_batches(feature_paths):
    """``PrefetchLoader`` around the port's test loader gives the JAX
    package's ``PrefetchLoader`` batches, in order, and its length."""
    tpath, jpath = feature_paths
    ours = tloaders.PrefetchLoader(tloaders.get_loaders(tpath, batch_size=2)[2])
    theirs = jloaders.PrefetchLoader(
        jloaders.get_loaders(jpath, batch_size=2, num_workers=0)[2])
    assert len(ours) == len(theirs) and ours.num_examples() == theirs.num_examples()
    got, want = list(ours), list(theirs)
    assert len(got) == len(want) == len(ours)
    for i, (a, b) in enumerate(zip(got, want)):
        _assert_same(a, b, f"batch {i}")


class _Failing:
    def __len__(self):
        return 3

    def __iter__(self):
        yield {"i": 0}
        raise OSError("pickle read failed")


def test_prefetch_loader_forwards_the_threads_exception():
    it = iter(tloaders.PrefetchLoader(_Failing()))
    assert next(it) == {"i": 0}
    with pytest.raises(OSError, match="pickle read failed"):
        next(it)


def test_prefetch_loader_consumer_that_stops_early_leaves_no_blocked_thread():
    import threading

    class Endless:
        def __len__(self):
            return 10 ** 6

        def __iter__(self):
            i = 0
            while True:
                yield i
                i += 1

    before = set(threading.enumerate())
    for _ in range(3):
        it = iter(tloaders.PrefetchLoader(Endless(), depth=2))
        assert [next(it) for _ in range(5)] == list(range(5))
        it.close()  # the consumer walks away with the queue full
    workers = set(threading.enumerate()) - before
    for t in workers:
        t.join(timeout=5)
    assert not any(t.is_alive() for t in workers)
