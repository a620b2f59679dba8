"""The port's C collate (``ser_tpu_torch/native``) against its plain numpy
version and the JAX package's ``collate``, on the CPU.

- ``collate`` (the C scatter) bit-equal to ``collate_ref`` (numpy) and to
  the JAX ``collate`` for L padded to a bucket of default and of given
  ``buckets`` and to a given ``pad_length``, B as given or padded, the
  float32 fields and the int32 labels, with and without raw audio;
- the loaders' batches (given ``buckets``) equal to the JAX
  ``EpochLoader``'s on the same items and seed;
- ``pad_time_major`` and ``pad_batch_first`` on ragged rows; rows that do
  not fit the buffer (longer than L, more than B, two widths, another
  dtype) raise before the C loops run;
- a source that does not compile raises ``RuntimeError`` naming the
  command, and ``collate`` raises with it: there is no numpy fallback.
"""

import importlib

import numpy as np
import pytest

from ser_tpu.data.loaders import EpochLoader as JEpochLoader
from ser_tpu_torch import native
from ser_tpu_torch.data.collate import DEFAULT_BUCKETS, collate, collate_ref
from ser_tpu_torch.data.loaders import EpochLoader
from ser_tpu_torch.ops.kernels.build import build_c

# the package __init__ shadows the submodule name with the function
jcollate = importlib.import_module("ser_tpu.data.collate").collate


def _items(n=6, max_t=20, seed=0, wav=False):
    rng = np.random.default_rng(seed)
    items = []
    for i in range(n):
        t = int(rng.integers(3, max_t + 1))
        item = (*(rng.standard_normal((t, d)).astype(np.float32)
                  for d in (1024, 1024, 1024, 1024, 512, 100)),
                np.eye(2, dtype=np.float32)[rng.integers(0, 2, t)],
                np.ones(t, dtype=np.float32),
                rng.integers(0, 6, t).astype(np.int32),
                f"v{i}")
        if wav:
            item += (rng.standard_normal((t, int(rng.integers(900, 3000)))).astype(np.float32),)
        items.append(item)
    return items


def _equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if k == "vid":
            assert a[k] == b[k]
        else:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("wav", [False, True])
@pytest.mark.parametrize("pad", [
    dict(), dict(pad_batch=8), dict(pad_length=40, pad_batch=8),
    dict(buckets=(12, 50, 200)), dict(buckets=(12, 50, 200), pad_batch=7)])
def test_c_path_is_numpy_and_jax_bit_for_bit(pad, wav):
    items = _items(wav=wav)
    got = collate(items, **pad)
    _equal(got, collate_ref(items, **pad))
    _equal(got, jcollate(items, **pad))
    L = got["umask"].shape[1]
    assert L == pad.get("pad_length", 24 if "buckets" not in pad else 50)
    assert got["umask"].dtype == np.float32 and got["label"].dtype == np.int32


def test_loader_batches_equal_jax_with_buckets():
    items = _items(n=11, seed=3)
    buckets = (10, 30, 256)
    got = list(EpochLoader(items, np.arange(11), 4, seed=5, buckets=buckets))
    want = list(JEpochLoader(items, np.arange(11), 4, seed=5, buckets=buckets))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        _equal(a, b)
        assert a["umask"].shape[1] in buckets
    assert EpochLoader(items, np.arange(11), 4).buckets == DEFAULT_BUCKETS


def test_pad_time_major_ragged():
    rng = np.random.default_rng(1)
    arrays = [rng.standard_normal((t, 7)).astype(np.float32) for t in (3, 5, 2)]
    out = native.pad_time_major(arrays, L=6, B=4)
    assert out.shape == (6, 4, 7)
    for b, a in enumerate(arrays):
        np.testing.assert_array_equal(out[:a.shape[0], b], a)
        assert not out[a.shape[0]:, b].any()
    assert not out[:, 3].any()  # the padded batch column


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_pad_batch_first_dtypes(dtype):
    rows = [np.arange(1, t + 1).astype(dtype) for t in (2, 4)]
    out = native.pad_batch_first(rows, L=5, B=3, dtype=dtype)
    assert out.dtype == dtype and out.shape == (3, 5)
    np.testing.assert_array_equal(out[1, :4], np.arange(1, 5))
    assert not out[0, 2:].any() and not out[2].any()


@pytest.mark.parametrize("call", [
    lambda: native.pad_batch_first([np.ones(6, np.float32)], L=5, B=1),  # longer than L
    lambda: native.pad_batch_first([np.ones(2, np.float32)] * 3, L=5, B=2),  # more than B
    lambda: native.pad_batch_first([np.ones(2, np.float64)], L=5, B=1, dtype=np.float64),
    lambda: native.pad_time_major([np.ones((3, 4), np.float32), np.ones((3, 5), np.float32)],
                                  L=5, B=2),  # two widths
    lambda: native.pad_time_major([np.ones(3, np.float32)], L=5, B=1),  # not [T, D]
])
def test_rows_that_do_not_fit_raise_before_c_runs(call):
    with pytest.raises(ValueError):
        call()


def test_failed_build_raises_and_names_the_command(tmp_path, monkeypatch):
    broken = tmp_path / "broken_collate.c"
    broken.write_text("void pad_time_major( { not C }\n")
    with pytest.raises(RuntimeError, match="cc -O3 -shared -fPIC"):
        build_c(broken)
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="broken_collate.c"):
        collate(_items(n=2))
