"""The port's masked loss, Adam and StepLR against the JAX package, on the CPU.

Inputs come from numpy seeds and go to both sides. The loss matches at rtol
1e-6 (one log-softmax over six classes and a sum, in another order); Adam's
parameters at rtol 1e-5, atol 1e-7 over five steps (the tolerance of
``tests/test_optim_parity.py``), and a dead parameter (torch: ``.grad`` None,
JAX: an all-zero gradient) stays bit-equal to its init on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ser_tpu.train import losses as jlosses
from ser_tpu.train import optim as joptim
from ser_tpu_torch.train import losses, optim

N_CLASSES = 6


def _loss_inputs(seed=0, B=3, L=5):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B * L, N_CLASSES)).astype(np.float32)
    pred = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    target = rng.integers(0, N_CLASSES, B * L).astype(np.int32)
    mask = np.ones((B, L), np.float32)
    mask[0, 3:] = 0.0
    mask[2, 1:] = 0.0
    weight = rng.uniform(0.5, 2.0, N_CLASSES).astype(np.float32)
    return pred, target, mask, weight


@pytest.mark.parametrize("kind", ["CrossEntropy", "NLL"])
@pytest.mark.parametrize("weighted", [False, True])
def test_masked_loss_matches_jax(kind, weighted):
    pred, target, mask, weight = _loss_inputs()
    w = weight if weighted else None
    want = jlosses.masked_loss(jnp.asarray(pred), jnp.asarray(target),
                               jnp.asarray(mask), kind=kind,
                               weight=None if w is None else jnp.asarray(w))
    got = losses.masked_loss(torch.from_numpy(pred), torch.from_numpy(target),
                             torch.from_numpy(mask), kind=kind,
                             weight=None if w is None else torch.from_numpy(w))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_masked_nll_loss_is_nll_kind():
    pred, target, mask, _ = _loss_inputs(seed=1)
    args = (torch.from_numpy(pred), torch.from_numpy(target), torch.from_numpy(mask))
    assert losses.masked_nll_loss(*args).item() == losses.masked_loss(
        *args, kind="NLL").item()


def test_unknown_loss_kind_raises():
    pred, target, mask, _ = _loss_inputs()
    with pytest.raises(ValueError, match="unknown loss kind"):
        losses.masked_loss(torch.from_numpy(pred), torch.from_numpy(target),
                           torch.from_numpy(mask), kind="Hinge")


@pytest.mark.parametrize("kind", ["CrossEntropy", "NLL"])
def test_masked_rows_get_zero_gradient(kind):
    """Masked rows add log(C) (CrossEntropy) or 0 (NLL) to the loss and
    exactly zero gradient; the live rows' gradient equals the JAX one."""
    pred, target, mask, _ = _loss_inputs(seed=2)
    p = torch.from_numpy(pred).requires_grad_()
    loss = losses.masked_loss(p, torch.from_numpy(target), torch.from_numpy(mask),
                              kind=kind)
    loss.backward()
    dead = mask.reshape(-1) == 0
    assert dead.any()
    assert (p.grad[torch.from_numpy(dead)] == 0).all()
    jgrad = jax.grad(lambda x: jlosses.masked_loss(
        x, jnp.asarray(target), jnp.asarray(mask), kind=kind))(jnp.asarray(pred))
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgrad), rtol=1e-5,
                               atol=1e-7)
    if kind == "CrossEntropy":  # each masked row contributes log(C)
        live = losses.masked_loss(p[torch.from_numpy(~dead)].detach(),
                                  torch.from_numpy(target[~dead]),
                                  torch.ones(int((~dead).sum())))
        np.testing.assert_allclose(
            loss.item() * mask.sum(),
            live.item() * (~dead).sum() + dead.sum() * np.log(N_CLASSES), rtol=1e-5)


def test_adam_with_step_lr_matches_jax_and_skips_dead_params():
    rng = np.random.default_rng(0)
    p0 = {"w": rng.standard_normal((4, 6)).astype(np.float32),
          "dead": rng.standard_normal(5).astype(np.float32)}
    grads = [rng.standard_normal((4, 6)).astype(np.float32) for _ in range(5)]
    lr_at = optim.step_lr(1e-2, 0.5, 2)
    jlr_at = joptim.step_lr(1e-2, 0.5, 2)

    w = torch.nn.Parameter(torch.from_numpy(p0["w"].copy()))
    dead = torch.nn.Parameter(torch.from_numpy(p0["dead"].copy()))
    opt = optim.torch_adam([w, dead], lr=lr_at(1), weight_decay=2e-5)

    tx = joptim.torch_adam(weight_decay=2e-5)
    params = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(params)
    for epoch, g in enumerate(grads, start=1):
        assert lr_at(epoch) == jlr_at(epoch)
        opt.zero_grad(set_to_none=True)
        w.grad = torch.from_numpy(g)  # dead.grad stays None
        optim.set_lr(opt, lr_at(epoch))
        opt.step()
        state.hyperparams["learning_rate"] = jnp.float32(jlr_at(epoch))
        updates, state = tx.update(
            {"w": jnp.asarray(g), "dead": jnp.zeros(5, jnp.float32)}, state, params)
        params = optax.apply_updates(params, updates)
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(params["w"]),
                                   rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(dead.detach().numpy(), p0["dead"])
    np.testing.assert_array_equal(np.asarray(params["dead"]), p0["dead"])
    assert not np.array_equal(w.detach().numpy(), p0["w"])


def test_live_param_with_all_zero_grad_matches_jax_step_for_step():
    """A live parameter whose gradient is all zero for a step (a fully padded
    batch): the JAX package zeroes its update while Adam's moments and count
    advance (``_mask_dead_params``); the port restores it after the step."""
    rng = np.random.default_rng(1)
    p0 = rng.standard_normal((4, 6)).astype(np.float32)
    grads = [rng.standard_normal((4, 6)).astype(np.float32) for _ in range(5)]
    grads[2][:] = 0.0
    w = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = optim.torch_adam([w], lr=1e-2, weight_decay=2e-5)
    tx = joptim.torch_adam(weight_decay=2e-5)
    params = {"w": jnp.asarray(p0)}
    state = tx.init(params)
    state.hyperparams["learning_rate"] = jnp.float32(1e-2)
    for step, g in enumerate(grads):
        before = w.detach().clone()
        opt.zero_grad(set_to_none=True)
        w.grad = torch.from_numpy(g)
        opt.step()
        updates, state = tx.update({"w": jnp.asarray(g)}, state, params)
        params = optax.apply_updates(params, updates)
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(params["w"]),
                                   rtol=1e-5, atol=1e-7, err_msg=f"step {step}")
        if step == 2:
            assert torch.equal(w.detach(), before)
    assert opt.state[w]["step"].item() == 5


def test_zeroed_grad_would_drift_a_dead_param():
    """The trap torch's own Adam sets: a zero tensor in ``.grad`` lets the
    coupled decay move the parameter by about lr on Adam's first step. The
    port's Adam freezes it for that step, as the JAX package does."""
    p = torch.nn.Parameter(torch.full((3,), 2.0))
    plain = torch.optim.Adam([p], lr=1e-3, weight_decay=2e-5)
    p.grad = torch.zeros(3)
    plain.step()
    np.testing.assert_allclose(p.detach().numpy(), 2.0 - 1e-3, rtol=1e-6)
    q = torch.nn.Parameter(torch.full((3,), 2.0))
    opt = optim.torch_adam([q], lr=1e-3)
    q.grad = torch.zeros(3)
    opt.step()
    assert (q.detach() == 2.0).all()


def test_step_lr_is_jaxs():
    ours, theirs = optim.step_lr(1e-3, 0.98, 3), joptim.step_lr(1e-3, 0.98, 3)
    for epoch in range(1, 12):
        assert ours(epoch) == theirs(epoch)
    assert ours(4) == 1e-3 * 0.98
