"""The attention zoo's channel, spatial and sequence classes that no flag
reaches (``ser_tpu_torch/ops/attention_zoo.py``) against the JAX package's
(``ser_tpu/ops/attention_zoo.py``), on the CPU.

Each of the 20 classes (PolarizedSelfAttention with ``sequential`` False
and True) at a small width: the JAX module's ``init`` (abstract) gives the
tree's shapes, whose leaves are drawn from a seeded numpy generator (the
zoo's N(0, 0.001²) Linears and its ones-and-zeros norms and gates would
leave every nonlinearity and the BatchNorm statistics untested), and
``compat.from_jax.zoo_from_jax`` loads them into the port's module. A seeded
numpy input goes through both (JAX ``apply`` and its vjp in one compiled
call a class; eval mode):

- the outputs at rtol 1e-4, atol 1e-5;
- the gradients of a fixed weighted sum of the output, for the input and
  every parameter, within 1e-4 of each tensor's largest entry plus 1e-6 of
  the largest of all (AFTFull's key bias has a gradient of zero, up to
  rounding: a constant added to a key channel cancels in its softmax); the
  JAX gradient tree carried into the port's layout by the same map;
- the weight map round-trips both ways, bit for bit.

EMSA's attention-map dropout keeps 1 - p of the entries in train mode and
at rate 0 is the eval forward; UFOAttention gives NaN on a zero query row in
both packages (its XNorm has no epsilon) and agrees elsewhere.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ser_tpu.ops import attention_zoo as J
from ser_tpu_torch.compat.from_jax import zoo_from_jax, zoo_to_jax
from ser_tpu_torch.ops import attention_zoo as T
from ser_tpu_torch.ops.init import generator

# name -> (JAX module, port module from a generator, input shape, sequence op)
CASES = {
    "SEAttention": (lambda: J.SEAttention(16, 4),
                    lambda g: T.SEAttention(16, 4, generator=g), (2, 16, 6, 6), False),
    "ECAAttention": (lambda: J.ECAAttention(3),
                     lambda g: T.ECAAttention(3, generator=g), (2, 16, 6, 6), False),
    "CBAMChannelGate": (lambda: J.CBAMChannelGate(16, 4),
                        lambda g: T.CBAMChannelGate(16, 4, generator=g), (2, 16, 6, 6), False),
    "CBAMSpatialGate": (lambda: J.CBAMSpatialGate(5),
                        lambda g: T.CBAMSpatialGate(5, generator=g), (2, 16, 6, 6), False),
    "CBAMBlock": (lambda: J.CBAMBlock(16, 4, 5),
                  lambda g: T.CBAMBlock(16, 4, 5, generator=g), (2, 16, 6, 6), False),
    "SpatialGroupEnhance": (lambda: J.SpatialGroupEnhance(4),
                            lambda g: T.SpatialGroupEnhance(4, generator=g), (2, 16, 6, 6),
                            False),
    "CoordAttention": (lambda: J.CoordAttention(16, 16, 4),
                       lambda g: T.CoordAttention(16, 16, 4, generator=g), (2, 16, 5, 6), False),
    "TripletAttention": (lambda: J.TripletAttention(),
                         lambda g: T.TripletAttention(generator=g), (2, 16, 5, 6), False),
    "ShuffleAttention": (lambda: J.ShuffleAttention(16, 2),
                         lambda g: T.ShuffleAttention(16, 2, generator=g), (2, 16, 5, 5), False),
    "SKAttention": (lambda: J.SKAttention(16, (1, 3), 4, 1, 8),
                    lambda g: T.SKAttention(16, (1, 3), 4, 1, 8, generator=g), (2, 16, 6, 6),
                    False),
    "BAMBlock": (lambda: J.BAMBlock(16, 4, 3, 2),
                 lambda g: T.BAMBlock(16, 4, 3, 2, generator=g), (2, 16, 7, 7), False),
    "PSA": (lambda: J.PSA(16, 4, 4),
            lambda g: T.PSA(16, 4, 4, generator=g), (2, 16, 6, 6), False),
    "CoTAttention": (lambda: J.CoTAttention(16, 3),
                     lambda g: T.CoTAttention(16, 3, generator=g), (2, 16, 5, 5), False),
    "DoubleAttention": (lambda: J.DoubleAttention(16, 8, 8),
                        lambda g: T.DoubleAttention(16, 8, 8, generator=g), (2, 16, 6, 6), False),
    "DAModule": (lambda: J.DAModule(16, 3, 4, 4),
                 lambda g: T.DAModule(16, 3, 4, 4, generator=g), (2, 16, 4, 4), False),
    "PolarizedSelfAttention": (lambda: J.PolarizedSelfAttention(16, False),
                               lambda g: T.PolarizedSelfAttention(16, False, generator=g),
                               (2, 16, 5, 5), False),
    "PolarizedSelfAttention-sequential": (
        lambda: J.PolarizedSelfAttention(16, True),
        lambda g: T.PolarizedSelfAttention(16, True, generator=g), (2, 16, 5, 5), False),
    "S2Attention": (lambda: J.S2Attention(16),
                    lambda g: T.S2Attention(16, generator=g), (2, 16, 4, 5), False),
    "AFTFull": (lambda: J.AFTFull(8, 6),
                lambda g: T.AFTFull(8, 6, generator=g), (2, 6, 8), False),
    "UFOAttention": (lambda: J.UFOAttention(16, 4, 4, 4),
                     lambda g: T.UFOAttention(16, 4, 4, 4, generator=g), (2, 5, 16), True),
    "EMSA": (lambda: J.EMSA(16, 4, 4, 2, 4, 4, 2),
             lambda g: T.EMSA(16, 4, 4, 2, 4, 4, 2, generator=g), (2, 16, 16), True),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _redraw(shapes, rng):
    """A parameter tree with the shapes of ``shapes``, drawn from ``rng``: a
    kernel N(0, 1/fan_in) (its last axis the outputs), a running variance
    in [0.5, 1.5), a mean N(0, 0.1²), a norm's scale 1 + N(0, 0.1²), any
    other vector N(0, 0.5²)."""
    def leaf(path, v):
        name, shape = jax.tree_util.keystr(path), v.shape
        if name.endswith("_var']"):
            return rng.random(shape) + 0.5
        if name.endswith("_mean']"):
            return 0.1 * rng.standard_normal(shape)
        if name.endswith("_scale']"):
            return 1.0 + 0.1 * rng.standard_normal(shape)
        if len(shape) >= 2:
            return rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        return 0.5 * rng.standard_normal(shape)
    return jax.tree_util.tree_map_with_path(
        lambda p, v: np.asarray(leaf(p, v), np.float32), shapes)


def _call(mod, params, x, seq):
    return mod.apply({"params": params}, *((x, x, x) if seq else (x,)))


def jax_params(mod, x, seq, rng):
    """The JAX module's parameter tree, its shapes from an abstract ``init``
    (no values computed), its values ``_redraw``'s."""
    shapes = jax.eval_shape(lambda: mod.init(jax.random.PRNGKey(0),
                                             *((x, x, x) if seq else (x,))))["params"]
    return _redraw(shapes, rng)


@functools.lru_cache(maxsize=None)
def jax_case(name):
    """``(params, x, weights of the sum, JAX output, JAX gradients of the
    params, of x)``: the forward and its vjp in one compiled call (a
    module's op-by-op JAX forward and backward take several times as long
    on the CPU as its compile and run)."""
    make, _, shape, seq = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    x = rng.standard_normal(shape).astype(np.float32)
    mod = make()
    params = jax_params(mod, x, seq, rng)
    out_shape = jax.eval_shape(lambda: _call(mod, params, x, seq)).shape
    w = rng.standard_normal(out_shape).astype(np.float32)

    @jax.jit
    def forward_and_vjp(p, xi, wi):
        out, vjp = jax.vjp(lambda p, xi: _call(mod, p, xi, seq), p, xi)
        return out, vjp(wi)

    out, (gp, gx) = forward_and_vjp(params, x, w)
    return (params, x, w, np.asarray(out), jax.tree_util.tree_map(np.asarray, gp),
            np.asarray(gx))


def port_module(name, params):
    m = CASES[name][1](generator(0))
    m.load_state_dict(zoo_from_jax(m, params), strict=True)
    return m.eval()


def port_forward(m, x, seq):
    return m(x, x, x) if seq else m(x)


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_matches_jax(name):
    params, x, _, want, _, _ = jax_case(name)
    m = port_module(name, params)
    with torch.no_grad():
        got = port_forward(m, torch.tensor(x), CASES[name][3]).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", sorted(CASES))
def test_gradients_match_jax(name):
    params, x, w, _, gp, gx = jax_case(name)
    m = port_module(name, params)
    xt = torch.tensor(x, requires_grad=True)
    (port_forward(m, xt, CASES[name][3]) * torch.tensor(w)).sum().backward()
    want = {"input": gx, **{k: v.numpy() for k, v in zoo_from_jax(m, gp).items()}}
    got = {"input": xt.grad, **dict(m.named_parameters())}
    assert set(got) <= set(want)
    top = max(np.abs(want[key]).max() for key in got)
    for key, t in got.items():
        g = (t if key == "input" else t.grad).numpy()
        tol = 1e-4 * np.abs(want[key]).max() + 1e-6 * top
        assert np.abs(g - want[key]).max() <= tol, key


def _leaves(tree):
    return {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_weight_map_round_trips(name):
    params = jax_case(name)[0]
    m = port_module(name, params)
    back = _leaves(zoo_to_jax(m))
    want = _leaves(params)
    assert sorted(back) == sorted(want)
    for k, v in want.items():
        assert back[k].dtype == np.float32 and np.array_equal(back[k], v), k
    fresh = CASES[name][1](generator(1))
    again = zoo_from_jax(fresh, zoo_to_jax(fresh))
    assert again.keys() == fresh.state_dict().keys()
    assert all(torch.equal(v, fresh.state_dict()[k]) for k, v in again.items())


def test_emsa_dropout_kept_fraction_and_rate_zero():
    """Train mode drops 1 - p of the attention map's entries from the
    generator given to ``forward``; at rate 0 a train forward is eval's."""
    p, seen = 0.1, {}
    m = T.EMSA(16, 4, 4, 2, 4, 4, 2, dropout=p, generator=generator(0)).train()
    m.dropout.register_forward_hook(
        lambda mod, args, out: seen.update(a=args[0].detach(), out=out.detach()))
    x = torch.tensor(np.random.default_rng(3).standard_normal((64, 16, 16)), dtype=torch.float32)
    m(x, x, x, generator=torch.Generator().manual_seed(5))
    kept = float((seen["out"] != 0).sum() / (seen["a"] != 0).sum())
    n = int((seen["a"] != 0).sum())
    assert abs(kept - (1 - p)) <= 6 * np.sqrt(p * (1 - p) / n), kept
    kept_rows = seen["out"] != 0
    np.testing.assert_allclose(seen["out"][kept_rows].numpy(),
                               (seen["a"][kept_rows] / (1 - p)).numpy(), rtol=1e-6)
    off = T.EMSA(16, 4, 4, 2, 4, 4, 2, dropout=0.0, generator=generator(0))
    train = off.train()(x, x, x, generator=torch.Generator().manual_seed(5))
    assert torch.equal(train, off.eval()(x, x, x))


def test_ufo_nan_on_a_zero_row_in_both_packages():
    """``fc_q``'s bias zero, as initialised, and a query row of zeros: its q row is 0,
    ``XNorm`` divides 0 by 0, and that row of the output is NaN in both
    packages; the other rows agree."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    x[1, 3] = 0.0
    mod = J.UFOAttention(16, 4, 4, 4)
    params = jax_params(mod, x, True, rng)
    params["fc_q_bias"][:] = 0.0  # as initialised
    want = np.asarray(jax.jit(lambda p: _call(mod, p, x, True))(params))
    m = port_module("UFOAttention", params)
    with torch.no_grad():
        got = port_forward(m, torch.tensor(x), True).numpy()
    nan = np.zeros(want.shape, bool)
    nan[1, 3] = True
    assert np.array_equal(np.isnan(want), nan) and np.array_equal(np.isnan(got), nan)
    np.testing.assert_allclose(got[~nan], want[~nan], rtol=1e-4, atol=1e-5)
