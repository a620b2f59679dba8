"""The train form of the rank-1 cross attention and what the CUDA kernel is
built from, on the CPU.

- The plain version (``rank1_attention_ref``) with p = 0 against the JAX
  package's ``rank1_cross_attention``, forward and ``jax.grad``: rtol 1e-5,
  atol 1e-6 (f32 on both sides, 128-term sums in another order).
- The kernel's backward algebra, written in torch (``rank1_attention_bwd_ref``)
  on the kernel's mask, against autograd through the plain version, p = 0 and
  0.2: in float64, to 1e-12, so the algebra itself is what is checked; and at
  p = 0 against the JAX package's own analytic backward ``_rank1_vjp_bwd``.
- The dropout mask: the torch int64 hash against an independent numpy uint32
  implementation, bit for bit; its kept fraction; no correlation between
  neighbouring keys, rows or steps.
- The wrapper's constants against ``csrc/rank1_attention.cu``, the kernel's
  folded row key and its warp reduce-scatter layout in numpy.
- ``chip_smoke.py``'s SDPA yardstick at p = 0 against the plain version:
  within 1e-5 of each tensor's largest entry.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ser_tpu.ops import attention as jattn
from ser_tpu_torch.ops.attention import rank1_cross_attention_train
from ser_tpu_torch.ops.kernels import rank1

CSRC = Path(rank1.__file__).resolve().parents[2] / "csrc"
D = rank1.D


def _inputs(B, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x1 = (2.0 * rng.standard_normal((2, B, D))).astype(dtype)
    x2 = (0.5 * rng.standard_normal((2, B, D))).astype(dtype)
    wq = (1.0 + 0.1 * rng.standard_normal((2, D))).astype(dtype)
    wk = (1.0 + 0.3 * rng.standard_normal((2, D))).astype(dtype)
    g = rng.standard_normal((2, B, D)).astype(dtype)
    return x1, x2, wq, wk, g


def _seed(value=987654321):
    return torch.tensor([value], dtype=torch.int32)


def test_plain_train_form_p0_matches_jax_forward_and_grad():
    x1, x2, wq, wk, g = _inputs(3)
    ts = [torch.from_numpy(a).requires_grad_() for a in (x1, x2, wq, wk)]
    z = rank1.rank1_attention_ref(*ts, _seed(), 4, 0.0)
    grads = torch.autograd.grad(z, ts, torch.from_numpy(g))
    for d in range(2):
        args = tuple(jnp.asarray(a[d]) for a in (x1, x2, wq, wk))
        fn = lambda *a: jattn.rank1_cross_attention(*a, 0.2, True, None)
        want = fn(*args)
        np.testing.assert_allclose(z[d].detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)
        jgrads = jax.grad(lambda *a: jnp.sum(fn(*a) * g[d]),
                          argnums=(0, 1, 2, 3))(*args)
        for got, ref in zip(grads, jgrads):
            np.testing.assert_allclose(got[d].numpy(), np.asarray(ref),
                                       rtol=1e-5, atol=1e-6)


def test_train_form_without_mask_is_the_eval_form():
    x1, x2, wq, wk, _ = map(torch.from_numpy, _inputs(4, seed=1))
    from ser_tpu_torch.ops.attention import rank1_cross_attention

    got = rank1_cross_attention_train(x1, x2, wq, wk, None, 0.0)
    want = rank1_cross_attention(x1, x2, wq[:, None], wk[:, None])
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)


def _graph_nodes(fn):
    seen, todo = set(), [fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        todo.extend(n for n, _ in node.next_functions)
    return {type(n).__name__ for n in seen}


def test_row_max_is_detached():
    """m carries no gradient (JAX's stop_gradient): no max or min of wk lies
    on the output's autograd graph, and the x1 gradient is ``dalpha * s`` of
    the analytic backward."""
    x1, x2, wq, wk, g = map(torch.from_numpy, _inputs(2, seed=2, dtype=np.float64))
    ts = [t.clone().requires_grad_() for t in (x1, x2, wq, wk)]
    z = rank1_cross_attention_train(*ts, None, 0.0)
    nodes = _graph_nodes(z.grad_fn)
    assert "ExpBackward0" in nodes
    assert not any(n.startswith(("AmaxBackward", "AminBackward", "MaxBackward",
                                 "MinBackward")) for n in nodes), nodes
    (dx1,) = torch.autograd.grad(z, ts[:1], g)
    want = rank1.rank1_attention_bwd_ref(x1, x2, wq, wk, _seed(), 0, 0.0, g)[0]
    torch.testing.assert_close(dx1, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("p", [0.0, 0.2])
def test_kernel_backward_algebra_matches_autograd(p):
    x1, x2, wq, wk, g = map(torch.from_numpy, _inputs(3, seed=3, dtype=np.float64))
    ts = [t.clone().requires_grad_() for t in (x1, x2, wq, wk)]
    z = rank1.rank1_attention_ref(*ts, _seed(), 7, p)
    want = torch.autograd.grad(z, ts, g)
    got = rank1.rank1_attention_bwd_ref(x1, x2, wq, wk, _seed(), 7, p, g)
    for name, a, b in zip(("dx1", "dx2", "dwq", "dwk"), got, want):
        assert a.shape == b.shape, name
        torch.testing.assert_close(a, b, rtol=0, atol=1e-12, msg=name)


def test_kernel_backward_algebra_matches_jax_vjp_at_p0():
    x1, x2, wq, wk, g = _inputs(3, seed=4)
    got = rank1.rank1_attention_bwd_ref(
        *map(torch.from_numpy, (x1, x2, wq, wk)), _seed(), 0, 0.0,
        torch.from_numpy(g))
    for d in range(2):
        res = tuple(jnp.asarray(a[d]) for a in (x1, x2, wq, wk)) + (None,)
        want = jattn._rank1_vjp_bwd(0.0, res, jnp.asarray(g[d]))[:4]
        for a, b in zip(got, want):
            np.testing.assert_allclose(a[d].numpy(), np.asarray(b),
                                       rtol=1e-5, atol=1e-6)


def _fmix32_np(h):
    h = h.astype(np.uint32)
    with np.errstate(over="ignore"):
        h ^= h >> np.uint32(16)
        h *= np.uint32(0x85EBCA6B)
        h ^= h >> np.uint32(13)
        h *= np.uint32(0xC2B2AE35)
        h ^= h >> np.uint32(16)
    return h


def _hashes_np(seed, step, B):
    """The kernel's mask hashes in numpy uint32 arithmetic, which wraps."""
    u = np.uint32
    with np.errstate(over="ignore"):
        d = np.arange(2, dtype=np.uint32)
        step_key = _fmix32_np(u(seed) + _fmix32_np(u(2 * step) + d + u(0x9E3779B9)))
        row = (np.arange(B, dtype=np.uint32)[:, None] * u(D)
               + np.arange(D, dtype=np.uint32)[None, :])
        row_key = _fmix32_np(step_key[:, None, None]
                             + _fmix32_np(row + u(0x9E3779B9))[None])
        return _fmix32_np(row_key[..., None] ^ np.arange(D, dtype=np.uint32))


@pytest.mark.parametrize("seed,step,B", [(0, 0, 3), (987654321, 109, 5),
                                         (2 ** 31 - 1, 17, 1)])
def test_mask_hash_matches_numpy_bit_for_bit(seed, step, B):
    got = rank1.mask_hashes(_seed(seed), step, B).numpy()
    want = _hashes_np(seed, step, B)
    assert got.shape == (2, B, D, D) and got.min() >= 0 and got.max() < 2 ** 32
    np.testing.assert_array_equal(got.astype(np.uint32), want)


def test_negative_int32_seed_is_its_uint32():
    """The kernel reads the int32 seed as uint32."""
    np.testing.assert_array_equal(
        rank1.mask_hashes(_seed(-5), 3, 2).numpy(),
        rank1.mask_hashes(torch.tensor([2 ** 32 - 5]), 3, 2).numpy())


def test_mask_kept_fraction_and_independence():
    p, B = 0.2, 40
    keep = rank1.keep_mask(_seed(11), 3, B, p).numpy()  # 1.3 M draws
    sd = np.sqrt(p * (1 - p) / keep.size)
    assert abs(keep.mean() - (1 - p)) < 6 * sd
    x = keep.astype(np.float64) - keep.mean()
    corr = lambda a, b: float((a * b).mean() / np.sqrt((a * a).mean() * (b * b).mean()))
    n_k = x[..., 1:].size
    assert abs(corr(x[..., 1:], x[..., :-1])) < 6 / np.sqrt(n_k)  # keys k, k+1
    assert abs(corr(x[:, :, 1:], x[:, :, :-1])) < 6 / np.sqrt(n_k)  # rows i, i+1
    assert abs(corr(x[0], x[1])) < 6 / np.sqrt(x[0].size)  # the two directions
    later = rank1.keep_mask(_seed(11), 4, B, p).numpy().astype(np.float64)
    assert abs(corr(x, later - later.mean())) < 6 / np.sqrt(x.size)  # steps
    other_seed = rank1.keep_mask(_seed(12), 3, B, p).numpy().astype(np.float64)
    assert abs(corr(x, other_seed - other_seed.mean())) < 6 / np.sqrt(x.size)


def test_keep_threshold():
    assert rank1.keep_threshold(0.0) == 0
    assert rank1.keep_threshold(0.2) == int(0.2 * 2 ** 32)
    assert rank1.keep_mask(_seed(), 0, 2, 0.0).all()
    for bad in (-0.1, 1.0):
        with pytest.raises(ValueError, match="not in"):
            rank1.keep_threshold(bad)


def test_wrapper_constants_match_the_kernel_source():
    src = (CSRC / f"{rank1.NAME}.cu").read_text()
    hexconst = lambda name: int(re.search(
        rf"constexpr uint32_t {name} = (0x[0-9A-Fa-f]+)u;", src).group(1), 16)
    assert int(re.search(r"constexpr int D = (\d+);", src).group(1)) == rank1.D
    assert hexconst("FMIX_M1") == rank1.FMIX_M1
    assert hexconst("FMIX_M2") == rank1.FMIX_M2
    assert hexconst("SALT") == rank1.SALT
    scale = float(re.search(r"constexpr float SCALE = ([0-9.]+)f;", src).group(1))
    assert np.float32(scale) == np.float32(rank1.SCALE)
    # the hash of the source is the one this module reproduces
    assert "fmix32((uint32_t)seed[0] + fmix32(2u * (uint32_t)step + (uint32_t)d + SALT))" in src
    assert "fmix32(skey + fmix32((uint32_t)(b * D + i) + SALT))" in src
    # the per-pair hash: fmix32(rkey ^ k) with the first shift-xor folded
    # into the row key (test_folded_row_key_is_fmix32_bit_for_bit)
    assert "rpre = rkey ^ (rkey >> 16);" in src
    assert "fmix32_tail(rpre ^ (uint32_t)k) >= threshold" in src
    # the sums over b are deterministic: no float atomics, an integer ticket
    assert not re.search(r"atomicAdd\(\s*(dw|part|acc|\(float)", src)
    assert "atomicAdd(&ticket[d], 1)" in src
    assert "rank1_sum_rows_kernel" not in src  # the backward is one launch


def test_wrapper_runs_plain_version_on_cpu_and_checks_shapes():
    x1, x2, wq, wk, g = map(torch.from_numpy, _inputs(2, seed=5))
    got = rank1.rank1_attention(x1, x2, wq, wk, _seed(), 1, 0.2)
    torch.testing.assert_close(
        got, rank1.rank1_attention_ref(x1, x2, wq, wk, _seed(), 1, 0.2),
        rtol=0, atol=0)
    with pytest.raises(ValueError, match="wq"):
        rank1.check_consts(wq[:, :64].contiguous(), wk, _seed())
    with pytest.raises(ValueError, match="seed"):
        rank1.check_consts(wq, wk, torch.tensor([1], dtype=torch.int64))
    with pytest.raises(ValueError, match="not contiguous"):
        rank1.check_inputs(x1.transpose(1, 2).contiguous().transpose(1, 2), x2)
    with pytest.raises(ValueError, match="g: torch.float64"):
        rank1.check_inputs(x1, x2, g.double())
    with pytest.raises(ValueError, match="x2 on meta"):
        rank1.check_inputs(x1, x2.to("meta"))
    assert rank1.check_inputs(x1, x2, g) == 2
    with pytest.raises(ValueError, match="no rank-1 attention"):
        rank1.rank1_attention(*(t.to("meta") for t in (x1, x2, wq, wk)),
                              _seed().to("meta"), 0, 0.2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        rank1.Rank1Kernel(wq, wk, _seed(), 0.2)


def test_bind_on_cpu_is_the_plain_version_for_every_step():
    """What train_recurrence calls: wq, wk, the seed and p bound once."""
    x1, x2, wq, wk, _ = map(torch.from_numpy, _inputs(3, seed=6))
    attend = rank1.bind(wq, wk, _seed(), 0.2)
    for step in (0, 5):
        torch.testing.assert_close(
            attend(x1, x2, step),
            rank1.rank1_attention_ref(x1, x2, wq, wk, _seed(), step, 0.2),
            rtol=0, atol=0)
    with pytest.raises(ValueError, match="no rank-1 attention"):
        rank1.bind(wq.to("meta"), wk, _seed(), 0.2)


def test_folded_row_key_is_fmix32_bit_for_bit():
    """The kernel folds fmix32's first shift-xor into the row key: for
    k < 2^16, fmix32(r ^ k) == fmix32_tail((r ^ (r >> 16)) ^ k)."""
    rng = np.random.default_rng(7)
    r = rng.integers(0, 2 ** 32, size=(512, 1), dtype=np.uint64).astype(np.uint32)
    k = np.arange(D, dtype=np.uint32)[None, :]
    want = _fmix32_np(r ^ k)
    h = (r ^ (r >> np.uint32(16))) ^ k
    with np.errstate(over="ignore"):
        h = h * np.uint32(0x85EBCA6B)
        h ^= h >> np.uint32(13)
        h = h * np.uint32(0xC2B2AE35)
        h ^= h >> np.uint32(16)
    np.testing.assert_array_equal(h, want)


def _warp_sum_scatter_np(v):
    """The kernel's warp_sum_scatter over 32 lanes in numpy, ``v`` [32, N]
    a lane's values: each round a lane keeps the half its bit o selects and
    adds the partner's copy; then plain butterflies."""
    v = v.copy()
    lanes = np.arange(32)
    n, o = v.shape[1], 16
    while n > 1:
        h = n // 2
        up = (lanes & o) != 0
        send = np.where(up[:, None], v[:, :h], v[:, h:n])
        mine = np.where(up[:, None], v[:, h:n], v[:, :h])
        v = mine + send[lanes ^ o]
        n, o = h, o // 2
    total = v[:, 0]
    while o >= 1:
        total = total + total[lanes ^ o]
        o //= 2
    return total


@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_warp_sum_scatter_lane_layout(n):
    """Lane l ends with the warp's sum of value l / (32 / n): the layout the
    kernel reads a row group's sums from (den, num forward; den, num, A2, A3
    backward, each 32 / n lanes after the last)."""
    v = np.random.default_rng(n).integers(-1000, 1000, size=(32, n)).astype(np.float64)
    got = _warp_sum_scatter_np(v)
    np.testing.assert_array_equal(got, v.sum(0)[np.arange(32) // (32 // n)])


def test_sdpa_yardstick_is_the_same_function():
    """chip_smoke.py times F.scaled_dot_product_attention as the kernel's
    library call: at p = 0 it must compute the plain version's z and
    gradients, within 1e-5 of each tensor's largest entry."""
    import chip_smoke

    x1, x2, wq, wk, g = map(torch.from_numpy, _inputs(5, seed=8))
    outs = []
    for fn in (lambda *a: chip_smoke.rank1_sdpa(torch, *a, 0.0),
               lambda *a: rank1.rank1_attention_ref(*a, _seed(), 0, 0.0)):
        ts = [t.clone().requires_grad_() for t in (x1, x2, wq, wk)]
        z = fn(*ts)
        outs.append((z.detach(), *torch.autograd.grad(z, ts, g)))
    for name, a, b in zip(("z", "dx1", "dx2", "dwq", "dwk"), *outs):
        assert a.shape == b.shape, name
        assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item(), name
