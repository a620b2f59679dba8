"""The attention zoo's vision blocks (``ser_tpu_torch/ops/attention_zoo_vision.py``)
against the JAX package's (``ser_tpu/ops/attention_zoo_vision.py``), on the CPU.

Each of the 12 classes (and MBConvBlock, ViP with and without its biases,
GFNet at an even and an odd patch grid) at a small width, as
``test_torch_attention_zoo.py`` holds the zoo's other classes: the JAX
module's abstract ``init`` gives the tree's shapes, ``_redraw`` draws its
leaves from a seeded numpy generator (so that CrissCross's zero ``gamma``,
ACmix's identity shift and the ones-and-zeros norms leave nothing
untested), ``zoo_from_jax`` loads them into the port's module, and a seeded
input goes through both (JAX ``apply`` and its vjp in one compiled call a
class; eval mode):

- the outputs at rtol 1e-4, atol 1e-5;
- the gradients of a fixed weighted sum of the output, for the input and
  every parameter, within 1e-4 of each tensor's largest entry plus 1e-6 of
  the largest of all; GFNet's unused ``embedding`` keeps ``.grad`` None;
- the weight map round-trips both ways, bit for bit.

Beside them: ``_unfold`` / ``_fold`` at stride 1 and at stride > 1 with
padding, ``_rel_to_abs`` / ``_relative_logits_1d``, HaloAttention's inverted
mask (an interior block attends uniformly), ACmix's bias-free shift
convolution, CoAtNet's sequence pool dropping an odd last token, and its
attention dropout in train mode.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ser_tpu.ops import attention_zoo_vision as J
from ser_tpu_torch.compat.from_jax import zoo_from_jax, zoo_to_jax
from ser_tpu_torch.ops import attention_zoo_vision as T
from ser_tpu_torch.ops.init import generator
from test_torch_attention_zoo import _leaves, _redraw, one_torch_thread  # noqa: F401

# name -> (JAX module, port module from a generator, input shape)
CASES = {
    "ResidualAttention": (lambda: J.ResidualAttention(8, 10, 0.2),
                          lambda g: T.ResidualAttention(8, 10, 0.2, generator=g), (2, 8, 5, 5)),
    "ParNetAttention": (lambda: J.ParNetAttention(8),
                        lambda g: T.ParNetAttention(8, generator=g), (2, 8, 5, 5)),
    "CrissCrossAttention": (lambda: J.CrissCrossAttention(16),
                            lambda g: T.CrissCrossAttention(16, generator=g), (2, 16, 5, 6)),
    "WeightedPermuteMLP": (lambda: J.WeightedPermuteMLP(16, 4),
                           lambda g: T.WeightedPermuteMLP(16, 4, generator=g), (2, 4, 4, 16)),
    "WeightedPermuteMLP-qkv_bias": (
        lambda: J.WeightedPermuteMLP(16, 4, True),
        lambda g: T.WeightedPermuteMLP(16, 4, True, generator=g), (2, 4, 4, 16)),
    "OutlookAttention": (lambda: J.OutlookAttention(8, 2),
                         lambda g: T.OutlookAttention(8, 2, generator=g), (2, 6, 6, 8)),
    "MobileViTAttention": (
        lambda: J.MobileViTAttention(3, 32, 3, 2, 3, 2, 8, 32),
        lambda g: T.MobileViTAttention(3, 32, 3, 2, 3, 2, 8, 32, generator=g), (2, 3, 4, 6)),
    "GFNet": (lambda: J.GFNet(32, 32, 8, 2, 2, 10),
              lambda g: T.GFNet(32, 32, 8, 2, 2, 10, generator=g), (2, 3, 32, 32)),
    "GFNet-odd": (lambda: J.GFNet(16, 40, 8, 2, 1, 6),
                  lambda g: T.GFNet(16, 40, 8, 2, 1, 6, generator=g), (2, 3, 40, 40)),
    "HaloAttention": (lambda: J.HaloAttention(16, 2, 1, 4, 2),
                      lambda g: T.HaloAttention(16, 2, 1, 4, 2, generator=g), (2, 16, 6, 6)),
    "ACmix": (lambda: J.ACmix(16, 16, head=4),
              lambda g: T.ACmix(16, 16, head=4, generator=g), (2, 16, 5, 5)),
    "AxialAttention": (lambda: J.AxialAttention(16, heads=4),
                       lambda g: T.AxialAttention(16, heads=4, generator=g), (2, 16, 5, 6)),
    "MBConvBlock": (lambda: J.MBConvBlock(3, 8, 8),
                    lambda g: T.MBConvBlock(3, 8, 8, generator=g), (2, 8, 6, 6)),
    "MBConvBlock-expand": (lambda: J.MBConvBlock(3, 8, 12, expand_ratio=2),
                           lambda g: T.MBConvBlock(3, 8, 12, expand_ratio=2, generator=g),
                           (2, 8, 6, 6)),
    "CoAtNet": (lambda: J.CoAtNet(3, 32, (8, 12, 16, 24, 32)),
                lambda g: T.CoAtNet(3, 32, (8, 12, 16, 24, 32), generator=g), (2, 3, 32, 32)),
}
DEAD = {"GFNet": {"embedding.weight", "embedding.bias"},
        "GFNet-odd": {"embedding.weight", "embedding.bias"}}


@functools.lru_cache(maxsize=None)
def jax_case(name):
    """``(params, x, weights of the sum, JAX output, JAX gradients of the
    params, of x)``: the forward and its vjp in one compiled call."""
    make, _, shape = CASES[name]
    rng = np.random.default_rng(100 + sorted(CASES).index(name))
    x = rng.standard_normal(shape).astype(np.float32)
    mod = make()
    shapes = jax.eval_shape(lambda: mod.init(jax.random.PRNGKey(0), x))["params"]
    params = _redraw(shapes, rng)
    out_shape = jax.eval_shape(lambda: mod.apply({"params": params}, x)).shape
    w = rng.standard_normal(out_shape).astype(np.float32)

    @jax.jit
    def forward_and_vjp(p, xi, wi):
        out, vjp = jax.vjp(lambda p, xi: mod.apply({"params": p}, xi), p, xi)
        return out, vjp(wi)

    out, (gp, gx) = forward_and_vjp(params, x, w)
    return (params, x, w, np.asarray(out), jax.tree_util.tree_map(np.asarray, gp),
            np.asarray(gx))


def port_module(name, params):
    m = CASES[name][1](generator(0))
    m.load_state_dict(zoo_from_jax(m, params), strict=True)
    return m.eval()


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_matches_jax(name):
    params, x, _, want, _, _ = jax_case(name)
    with torch.no_grad():
        got = port_module(name, params)(torch.tensor(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", sorted(CASES))
def test_gradients_match_jax(name):
    params, x, w, _, gp, gx = jax_case(name)
    m = port_module(name, params)
    xt = torch.tensor(x, requires_grad=True)
    (m(xt) * torch.tensor(w)).sum().backward()
    want = {"input": gx, **{k: v.numpy() for k, v in zoo_from_jax(m, gp).items()}}
    got = {"input": xt.grad, **{k: p.grad for k, p in m.named_parameters()}}
    dead = {k for k, g in got.items() if g is None}
    assert dead == DEAD.get(name, set())
    assert all(not want[k].any() for k in dead)
    top = max(np.abs(want[k]).max() for k in got)
    for key, g in got.items():
        if g is not None:
            tol = 1e-4 * np.abs(want[key]).max() + 1e-6 * top
            assert np.abs(g.numpy() - want[key]).max() <= tol, key


@pytest.mark.parametrize("name", sorted(CASES))
def test_weight_map_round_trips(name):
    params = jax_case(name)[0]
    back, want = _leaves(zoo_to_jax(port_module(name, params))), _leaves(params)
    assert sorted(back) == sorted(want)
    for k, v in want.items():
        assert back[k].dtype == np.float32 and np.array_equal(back[k], v), k
    fresh = CASES[name][1](generator(1))
    again = zoo_from_jax(fresh, zoo_to_jax(fresh))
    assert again.keys() == fresh.state_dict().keys()
    assert all(torch.equal(v, fresh.state_dict()[k]) for k, v in again.items())


@pytest.mark.parametrize("k, pad, stride, hw", [(3, 1, 1, (5, 6)), (4, 1, 2, (6, 6)),
                                                (5, 2, 3, (9, 7))])
def test_unfold_fold_match_jax(k, pad, stride, hw):
    rng = np.random.default_rng(k)
    x = rng.standard_normal((2, 3, *hw)).astype(np.float32)
    want, want_hw = J._unfold(jnp.asarray(x), k, pad, stride)
    got, got_hw = T._unfold(torch.tensor(x), k, pad, stride)
    assert got_hw == want_hw
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    cols = rng.standard_normal(want.shape).astype(np.float32)
    np.testing.assert_allclose(T._fold(torch.tensor(cols), hw, k, pad, stride).numpy(),
                               np.asarray(J._fold(jnp.asarray(cols), hw, k, pad, stride)),
                               rtol=1e-6, atol=1e-6)


def test_relative_logits_match_jax():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 4, 7)).astype(np.float32)
    np.testing.assert_array_equal(T._rel_to_abs(torch.tensor(x)).numpy(),
                                  np.asarray(J._rel_to_abs(jnp.asarray(x))))
    q = rng.standard_normal((2, 3, 3, 5)).astype(np.float32)
    rel = rng.standard_normal((9, 5)).astype(np.float32)
    np.testing.assert_allclose(
        T._relative_logits_1d(torch.tensor(q), torch.tensor(rel)).numpy(),
        np.asarray(J._relative_logits_1d(jnp.asarray(q), jnp.asarray(rel))), rtol=1e-6,
        atol=1e-6)


def test_halo_interior_block_attends_uniformly():
    """The vendored mask fills the VALID positions, so a block whose haloed
    window lies inside the map (all valid) gives every query the mean of the
    window's values, through ``to_out``."""
    params, x, *_ = jax_case("HaloAttention")
    m = port_module("HaloAttention", params)
    xt = torch.tensor(x)
    with torch.no_grad():
        out = m(xt)
        window = xt[:, :, 1:5, 1:5].flatten(2).transpose(1, 2)  # block (1, 1), halo 1
        v = m.to_kv(window).chunk(2, -1)[1]
        want = m.to_out(v.mean(1))  # [B, C]
    block = out[:, :, 2:4, 2:4].flatten(2).transpose(1, 2)  # its 4 queries
    np.testing.assert_allclose(block.numpy(), want[:, None].expand_as(block).numpy(),
                               rtol=1e-5, atol=1e-6)


def test_acmix_shift_conv_has_no_bias_and_starts_as_the_identity_shift():
    m = T.ACmix(16, 16, head=4, generator=generator(0))
    assert m.dep_conv.bias is None and "dep_conv.bias" not in m.state_dict()
    w = m.dep_conv.weight  # [out, 9, 3, 3]: tap i reads input channel i
    assert torch.equal(w, torch.eye(9).reshape(9, 3, 3)[None].expand_as(w))
    assert m.rate1.item() == m.rate2.item() == 0.5


def test_coatnet_sequence_pool_drops_an_odd_last_token():
    t = torch.tensor(np.random.default_rng(3).standard_normal((2, 7, 3)), dtype=torch.float32)
    want = np.max(t.numpy()[:, :6].reshape(2, 3, 2, 3), axis=2)
    np.testing.assert_array_equal(T.CoAtNet._pool_sequence(t).numpy(), want)


def test_coatnet_dropout_kept_fraction_and_rate_zero():
    """Train mode drops 1 - p of the attention entries of s3 and s4 from
    the generator given to ``forward``; at rate 0 a train forward is eval's;
    train mode without a generator raises."""
    p, seen = 0.1, []
    params, x, *_ = jax_case("CoAtNet")
    m = port_module("CoAtNet", params).train()
    for att in (m.s3, m.s4):
        att.dropout.register_forward_hook(
            lambda mod, args, out: seen.append((args[0].detach(), out.detach())))
    xt = torch.tensor(np.repeat(x, 8, axis=0))
    m(xt, generator=torch.Generator().manual_seed(5))
    n = sum(int((a != 0).sum()) for a, _ in seen)
    kept = sum(int((o != 0).sum()) for _, o in seen) / n
    assert abs(kept - (1 - p)) <= 6 * np.sqrt(p * (1 - p) / n), kept
    for a, o in seen:
        np.testing.assert_allclose(o[o != 0].numpy(), (a[o != 0] / (1 - p)).numpy(), rtol=1e-6)
    with pytest.raises(RuntimeError):
        m(xt)
    for att in (m.s3, m.s4):
        att.dropout.p = 0.0
    train = m(xt, generator=torch.Generator().manual_seed(5))
    assert torch.equal(train, m.eval()(xt))
