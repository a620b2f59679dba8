"""One train step of each rank-1 MARN1 variant against the JAX package's, on
the CPU, and the variants' train-mode dropouts.

For sp, cf, azs, sps, nsps and no_en at full width, [9, 3]: the same
JAX-initialised weights on both sides through ``from_jax_params``, with the
parameters the reference initialises to a constant re-seeded on both sides
(``tests/test_torch_meld.py::randomize_constants`` says why), and dropout
off on both sides (``tests/test_torch_train_step.py::run_step``). The
contract is PERF.md §2's: the loss at rtol 1e-5; every gradient within 1e-3
of its tensor's largest entry plus 1e-6 of the step's largest; the port's
dead set (``.grad`` None) equal to the JAX package's all-zero set; the
updated parameters within 2.05 lr.

With dropout on: a train forward is finite, reproducible from the
generator's seed and differs from eval; the h dropouts keep 1 - 0.5 and the
rank-1 attention's mask 1 - 0.2 of their draws, within 6 standard
deviations (the random bits differ from the JAX package's by design); eval
binds the attention at p = 0. One intra-op thread, as the other train test
files.
"""

import numpy as np
import pytest
import torch

from ser_tpu_torch.data.synthetic import synthetic_batch
from ser_tpu_torch.models import marn_variants
from ser_tpu_torch.models.registry import build_model, get_model_spec
from ser_tpu_torch.ops.init import generator
from ser_tpu_torch.ops.kernels import rank1
from test_torch_meld import randomize_constants
from test_torch_train_step import LR, grad_tolerance, no_dropout, port_grads, run_step

VARIANTS = ("MARN1_sp", "MARN1_cf", "MARN1_azs", "MARN1_sps", "MARN1_nsps", "MARN1_no_en")
L, B = 9, 3
# the JAX package's all-zero gradients of a step: the parameters the
# reference declares and never uses (per cell: the unused S projections,
# lstm_s or gru_l, crossatt_l2a.Wv and crossatt_a2l's three vectors; the
# encoders' pos_ffn.fc; the model's own unused modules)
DEAD = {"MARN1_sp": 34, "MARN1_cf": 25, "MARN1_azs": 18, "MARN1_sps": 20,
        "MARN1_nsps": 22, "MARN1_no_en": 34}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """``run_step``'s result for each variant, made at first use."""
    cache = {}

    def get(name):
        if name not in cache:
            res_csv = str(tmp_path_factory.mktemp(name) / "res.csv")
            cache[name] = run_step(res_csv, model=name, init=randomize_constants)
        return cache[name]
    return get


@pytest.mark.parametrize("name", VARIANTS)
def test_loss_matches_jax(steps, name):
    step = steps(name)
    np.testing.assert_allclose(step["loss"].item(), step["jloss"], rtol=1e-5)


@pytest.mark.parametrize("name", VARIANTS)
def test_every_gradient_matches_jax(steps, name):
    step = steps(name)
    grads = port_grads(step["pt"].model)
    assert sorted(grads) == sorted(step["jgrads"])
    tol = grad_tolerance(step["jgrads"])
    for key, g in grads.items():
        if g is not None:
            want = np.asarray(step["jgrads"][key])
            assert g.shape == want.shape, key
            np.testing.assert_array_less(np.abs(g - want), tol[key], err_msg=key)


@pytest.mark.parametrize("name", VARIANTS)
def test_dead_set_is_jaxs_all_zero_set(steps, name):
    step = steps(name)
    grads = port_grads(step["pt"].model)
    dead = {n for n, g in grads.items() if g is None}
    jax_zero = {n for n, g in step["jgrads"].items() if not np.any(np.asarray(g))}
    assert dead == jax_zero
    assert len(dead) == DEAD[name]
    assert "marn_cell_f/crossatt_a2l_Wq" in dead and "marn_cell_b/crossatt_l2a_Wv" in dead
    assert "marn_cell_f/crossatt_l2a_Wq" not in dead


@pytest.mark.parametrize("name", VARIANTS)
def test_updated_parameters_within_two_lr(steps, name):
    step = steps(name)
    from ser_tpu_torch.compat.from_jax import to_jax_params

    after = to_jax_params(step["pt"].model.state_dict())
    for key, want in step["new_params"].items():
        np.testing.assert_array_less(np.abs(after[key] - np.asarray(want)), 2.05 * LR,
                                     err_msg=key)
    for key, g in port_grads(step["pt"].model).items():  # dead ones did not move
        if g is None:
            np.testing.assert_array_equal(after[key], np.asarray(step["params"][key]))


def _inputs(name, seed=1):
    batch = synthetic_batch(L=L, B=B, seed=seed, min_len=4)
    return tuple(map(torch.as_tensor, get_model_spec(name).make_inputs(batch)))


@pytest.mark.parametrize("name", VARIANTS)
def test_train_forward_is_seeded_and_differs_from_eval(name):
    model = build_model(name, generator(0)).train()
    inputs = _inputs(name)
    run = lambda seed: model(*inputs, generator=torch.Generator().manual_seed(seed))[0]  # noqa: E731
    a, b, c = run(5), run(5), run(6)
    assert torch.isfinite(a).all()
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    model.eval()
    e = model(*inputs)[0]
    assert not torch.equal(a, e)
    model.train()
    no_dropout(model)
    torch.testing.assert_close(run(5), e, rtol=1e-5, atol=1e-5)
    with pytest.raises(RuntimeError, match="eval"):
        model(*inputs)


@pytest.mark.parametrize("name", VARIANTS)
def test_kept_fractions_of_the_recurrence_dropouts(name, monkeypatch):
    """The cells' h dropouts (none in cf and azs) keep half their draws;
    the rank-1 attention is bound once a forward, at p = 0.2 in train and
    p = 0 in eval, and its mask keeps 0.8 of the draws of every step."""
    drawn, binds = [], []

    def recording_dropout(x, p, generator):
        out = real_dropout(x, p, generator)
        drawn.append((p, out.numel(), int((out != 0).sum())))
        return out

    def recording_bind(wq, wk, seed, p):
        binds.append((seed.clone(), p))
        return bind(wq, wk, seed, p)

    real_dropout, bind = marn_variants.dropout, marn_variants.rank1_bind
    monkeypatch.setattr(marn_variants, "dropout", recording_dropout)
    monkeypatch.setattr(marn_variants, "rank1_bind", recording_bind)
    model = build_model(name, generator(0)).train()
    inputs = _inputs(name)
    model(*inputs, generator=torch.Generator().manual_seed(3))
    (seed, p), = binds
    assert p == 0.2 and seed.dtype == torch.int32
    draws = 2 * B * 128 * 128 * L
    kept = sum(int(rank1.keep_mask(seed, t, B, p).sum()) for t in range(L))
    assert abs(kept / draws - 0.8) < 6 * np.sqrt(0.2 * 0.8 / draws)
    n_drops = {"MARN1_cf": 0, "MARN1_azs": 0}.get(name, 3 * L)
    assert len(drawn) == n_drops and all(q == 0.5 for q, _, _ in drawn)
    if drawn:
        n, k = sum(d[1] for d in drawn), sum(d[2] for d in drawn)
        assert abs(k / n - 0.5) < 6 * np.sqrt(0.25 / n)
    model.eval()
    model(*inputs)
    assert binds[1][1] == 0.0 and len(drawn) == n_drops
