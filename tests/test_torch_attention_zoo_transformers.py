"""The attention zoo's Swin-family backbones
(``ser_tpu_torch/ops/attention_zoo_transformers.py``) against the JAX
package's (``ser_tpu/ops/attention_zoo_transformers.py``), on the CPU.

CrossFormer, MOATransformer and DAT at the JAX oracle tests' small
configurations, as ``test_torch_attention_zoo.py`` holds the zoo's other
classes: ``_redraw``'s seeded leaves (the 0.01 position tables and the
ones-and-zeros norms would leave much untested) carried across by
``zoo_from_jax``, a seeded input through both (JAX ``apply`` and its vjp in
one compiled call a class):

- the outputs at rtol 1e-4, atol 1e-5;
- the gradients of a fixed weighted sum of the output, for the input and
  every parameter, within 1e-4 of each tensor's largest entry plus 1e-6 of
  the largest of all;
- the weight map round-trips both ways, bit for bit.

These comparisons pin what the JAX package keeps of the vendored code:
MOA's raw ``[B, HW, C]`` -> ``[B, C, H, W]`` reshapes and raw query view (a
permute gives other numbers), the tanh GELU of the MLPs and DAT's exact
one in its offset network. Beside them: ``window_partition`` /
``window_reverse``, ``relative_position_index`` and ``grid_sample_bilinear``
(points outside [-1, 1], with its gradients) against the JAX helpers, and
MOA's key unfold at stride 14: at window 7 both packages fail alike.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ser_tpu.ops import attention_zoo_transformers as J
from ser_tpu_torch.compat.from_jax import zoo_from_jax, zoo_to_jax
from ser_tpu_torch.ops import attention_zoo_transformers as T
from ser_tpu_torch.ops.init import generator
from test_torch_attention_zoo import _leaves, _redraw, one_torch_thread  # noqa: F401

CROSS = dict(img_size=32, patch_size=(4, 8), num_classes=10, embed_dim=32, depths=(2, 2),
             num_heads=(2, 4), group_size=(4, 4), merge_size=((2, 4),))
MOA = dict(img_size=112, patch_size=4, num_classes=10, embed_dim=32, depths=(2, 2),
           num_heads=(2, 4), window_size=14)
DAT = dict(img_size=64, patch_size=4, num_classes=10, dim_stem=16, dims=(16, 32, 64, 128),
           depths=(2, 2, 2, 2), heads=(2, 2, 4, 4), window_sizes=(4, 4, 4, 2),
           strides=(-1, -1, 1, 1), offset_range_factor=(-1, -1, 2, 2),
           stage_spec=(("L", "S"), ("L", "S"), ("L", "D"), ("L", "D")),
           groups=(-1, -1, 2, 2), use_pes=(False, False, True, True))
# name -> (keyword arguments of both classes, input shape)
CASES = {"CrossFormer": (CROSS, (2, 3, 32, 32)),
         "MOATransformer": (MOA, (2, 3, 112, 112)),
         "DAT": (DAT, (2, 3, 64, 64))}


@functools.lru_cache(maxsize=None)
def jax_case(name):
    """``(params, x, weights of the sum, JAX output, JAX gradients of the
    params, of x)``: the forward and its vjp in one compiled call."""
    kwargs, shape = CASES[name]
    rng = np.random.default_rng(200 + sorted(CASES).index(name))
    x = rng.standard_normal(shape).astype(np.float32)
    mod = getattr(J, name)(**kwargs)
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


def port_module(name, params=None, seed=0):
    m = getattr(T, name)(**CASES[name][0], generator=generator(seed))
    if params is not None:
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
    assert set(got) == set(want) and all(g is not None for g in got.values())
    top = max(np.abs(want[k]).max() for k in got)
    for key, g in got.items():
        tol = 1e-4 * np.abs(want[key]).max() + 1e-6 * top
        assert np.abs(g.numpy() - want[key]).max() <= tol, key


@pytest.mark.parametrize("name", sorted(CASES))
def test_weight_map_round_trips(name):
    params = jax_case(name)[0]
    back, want = _leaves(zoo_to_jax(port_module(name, params))), _leaves(params)
    assert sorted(back) == sorted(want)
    for k, v in want.items():
        assert back[k].dtype == np.float32 and np.array_equal(back[k], v), k
    fresh = port_module(name, seed=1)
    again = zoo_from_jax(fresh, zoo_to_jax(fresh))
    assert again.keys() == fresh.state_dict().keys()
    assert all(torch.equal(v, fresh.state_dict()[k]) for k, v in again.items())


@pytest.mark.parametrize("ws, hw", [(2, (4, 6)), (3, (6, 3)), (4, (8, 8))])
def test_window_partition_and_reverse_match_jax(ws, hw):
    x = np.random.default_rng(ws).standard_normal((2, *hw, 5)).astype(np.float32)
    want = np.asarray(J.window_partition(jnp.asarray(x), ws))
    got = T.window_partition(torch.tensor(x), ws)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(T.window_reverse(got, ws, *hw).numpy(), x)
    np.testing.assert_array_equal(
        T.window_reverse(got, ws, *hw).numpy(),
        np.asarray(J.window_reverse(jnp.asarray(want), ws, *hw)))


@pytest.mark.parametrize("wh, ww", [(1, 1), (3, 3), (2, 4), (7, 7)])
def test_relative_position_index_matches_jax(wh, ww):
    got, want = T.relative_position_index(wh, ww), J.relative_position_index(wh, ww)
    assert got.shape == (wh * ww, wh * ww)
    np.testing.assert_array_equal(got, want)
    assert got.min() == 0 and got.max() == (2 * wh - 1) * (2 * ww - 1) - 1


def test_grid_sample_matches_jax_outside_the_square_too():
    """Points over [-1.4, 1.4]: some taps of each corner fall outside the map
    and read zero. The output, and the gradients of a weighted sum for the
    map and the grid."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 3, 5, 6)).astype(np.float32)
    grid = rng.uniform(-1.4, 1.4, (2, 4, 7, 2)).astype(np.float32)
    w = rng.standard_normal((2, 3, 4, 7)).astype(np.float32)
    assert (np.abs(grid) > 1).any(axis=-1).mean() > 0.3
    out, vjp = jax.vjp(J.grid_sample_bilinear, jnp.asarray(x), jnp.asarray(grid))
    gx, gg = vjp(jnp.asarray(w))
    xt, gt = torch.tensor(x, requires_grad=True), torch.tensor(grid, requires_grad=True)
    got = T.grid_sample_bilinear(xt, gt)
    (got * torch.tensor(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gt.grad.numpy(), np.asarray(gg), rtol=1e-4, atol=1e-5)


def test_moa_key_unfold_stride_is_14_whatever_the_window():
    """At window 7 on a 28-token side the queries are 4 windows a side but
    the stride-14 unfold gives 2 key windows a side: both packages fail to
    shape the keys, as the vendored module does."""
    kwargs = dict(MOA, img_size=112, window_size=7)
    x = np.zeros((1, 3, 112, 112), np.float32)
    with pytest.raises(TypeError):
        jax.eval_shape(lambda: J.MOATransformer(**kwargs).init(jax.random.PRNGKey(0), x))
    with pytest.raises(RuntimeError):
        T.MOATransformer(**kwargs, generator=generator(0))(torch.tensor(x))
