"""The port's DialogueRNN (``models/dialogue_rnn.py::BiModel``) against the
benchmark's plain float64 reference of the published model
(``benchmark/reference/DialogueRNN.py``), on the CPU, on seeded random
weights: the log-probabilities at small widths and at the published ones
on a [9, 4] batch with padded rows and both parties speaking, one train
step with every dropout at 0 (loss, every parameter's gradient, the
parameters after Adam), and the reference's FLOP count against
``FlopCounterMode`` at shapes it was not fitted on.

Each comparison is also run against a broken side, which must fail it: the
inputs or the weights rounded through bfloat16, the listener's update
skipped, a non-zero context at the first step. So the tolerances are tight
enough to see a precision below float32 or a step of the model left out."""

import numpy as np
import pytest
import torch

from benchmark.reference import DialogueRNN as R
from benchmark.reference import common
from benchmark.tests.test_bench_flops import counted
from benchmark.train_epochs import dropout_off
from benchmark.weights import make_weights
from ser_tpu_torch.data.synthetic import synthetic_batch
from ser_tpu_torch.models.dialogue_rnn import BiModel
from ser_tpu_torch.models.registry import get_model_spec
from ser_tpu_torch.ops.init import generator
from ser_tpu_torch.train.trainer import ModelTrainer

CONFIG = {"text_views": 4}
SMALL = dict(D_m=16, D_g=12, D_p=10, D_e=8, D_h=6)  # every width distinct
L, B = 9, 4
LR, DECAY = 1e-3, 2e-5
# Tolerances, each over the reference's float64 numbers, between what
# float32 reads here and what the broken sides read:
# - log-probabilities, absolute: float32 rounding through 9 steps of the
#   GRUs and attentions reads 1.8e-7 to 1.9e-7; a bfloat16 round trip of
#   the inputs 1.1e-4 to 1.2e-4, of the weights 2.1e-4 to 6.1e-4, the
#   planted changes 1.7e-3 or more
LOGP_TOL = 5e-6
# - the loss, relative: float32 reads 6.4e-8, bfloat16 inputs 3.5e-6
LOSS_TOL = 1e-6
# - a gradient or a change by Adam, the norm of the difference over the
#   reference leaf's norm, worst leaf: float32 reads 9.9e-7 on the
#   gradients and 4.5e-5 on the changes (Adam moves an element whose
#   gradient is within rounding of 0 by about lr either way); bfloat16
#   inputs or weights 4.6e-2 and 0.23 or more
GRAD_TOL = 1e-4
CHANGE_TOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed=3):
    """[9, 4] with padded rows, both parties speaking among the valid steps."""
    batch = synthetic_batch(L=L, B=B, seed=seed, min_len=4)
    valid = batch["umask"].T > 0
    assert not valid.all()
    assert set(batch["qmask"][valid].argmax(-1)) == {0, 1}
    return batch


def _tensors(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items() if k != "vid"}


def _bf16(t):
    return t.to(torch.bfloat16).to(t.dtype)


def _listener_skipped(monkeypatch):
    gru_cell = R.gru_cell
    monkeypatch.setattr(R, "gru_cell", lambda P, name, x, h: h if name.endswith(
        ".l_cell") else gru_cell(P, name, x, h))


def _first_context_nonzero(monkeypatch):
    context = R.context
    monkeypatch.setattr(R, "context", lambda P, cell, U, g_hist: context(
        P, cell, U, g_hist) if g_hist.shape[0] else U.new_full(
        (U.shape[0], g_hist.shape[-1]), 0.1))


BROKEN = ["inputs_bf16", "weights_bf16", "listener_skipped", "first_context_nonzero"]


def _reference_logp(weights, x, qmask, umask, broken, monkeypatch):
    P = {n: w.double() for n, w in weights.items()}
    x = x.double()
    if broken == "inputs_bf16":
        x = _bf16(x)
    elif broken == "weights_bf16":
        P = {n: _bf16(w) for n, w in P.items()}
    elif broken == "listener_skipped":
        _listener_skipped(monkeypatch)
    elif broken == "first_context_nonzero":
        _first_context_nonzero(monkeypatch)
    with torch.no_grad():
        return R.forward(P, x, qmask.double(), umask.double())


def _small_case():
    weights = make_weights(R.param_table(6, **SMALL), 7, "cpu")
    model = BiModel(**SMALL, generator=generator(0)).eval()
    model.load_state_dict(weights, strict=True)
    batch = _batch()
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.standard_normal((L, B, SMALL["D_m"])).astype(np.float32)
                        * batch["umask"].T[..., None])
    qmask, umask = torch.as_tensor(batch["qmask"]), torch.as_tensor(batch["umask"])
    with torch.no_grad():
        logp = get_model_spec("DialogueRNN").extract_logp(model(x, qmask, umask))
    return weights, x, qmask, umask, logp


def _published_case():
    weights = make_weights(R.param_table(6), 11, "cpu")
    model = BiModel(generator=generator(0)).eval()
    model.load_state_dict(weights, strict=True)
    batch = _batch()
    spec = get_model_spec("DialogueRNN")
    x, qmask, umask = (torch.as_tensor(a) for a in spec.make_inputs(batch))
    with torch.no_grad():
        logp = spec.extract_logp(model(x, qmask, umask))
    return weights, R.inputs(_tensors(batch), CONFIG), qmask, umask, logp


CASES = {"small": _small_case, "published": _published_case}


def _logp_gap(case, broken, monkeypatch):
    weights, x, qmask, umask, logp = CASES[case]()
    ref = _reference_logp(weights, x, qmask, umask, broken, monkeypatch)
    assert logp.dtype == torch.float32 and logp.shape == ref.shape == (B * L, 6)
    return float((logp.double() - ref).abs().max())


@pytest.mark.parametrize("case", CASES)
def test_log_probabilities_are_the_references(case, monkeypatch):
    assert _logp_gap(case, None, monkeypatch) < LOGP_TOL


@pytest.mark.parametrize("broken", BROKEN)
@pytest.mark.parametrize("case", CASES)
def test_log_probabilities_see_a_broken_side(case, broken, monkeypatch):
    assert _logp_gap(case, broken, monkeypatch) > LOGP_TOL


def test_inputs_are_the_programs_trimodal_input():
    # [the text views' mean's first 100 dims | audio | visual], float64
    batch = _batch()
    x = R.inputs(_tensors(batch), CONFIG)
    want, _, _ = get_model_spec("DialogueRNN").make_inputs(batch)
    assert x.dtype == torch.float64 and x.shape == (L, B, 712)
    np.testing.assert_allclose(x.numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(x[..., 100:].numpy(), want[..., 100:])


def _program_step(weights):
    """One train step of the program with every dropout at 0: ``(loss,
    gradients, changes)`` by parameter name."""
    trainer = ModelTrainer(device="cpu", model="DialogueRNN", seed=13, lr=LR,
                           weight_decay=DECAY)
    trainer.model.load_state_dict(weights, strict=True)
    dropout_off(trainer.model)
    loss = trainer._train_step_impl(_batch(), LR)
    named = dict(trainer.model.named_parameters())
    return (float(loss), {n: p.grad.double() for n, p in named.items()},
            {n: p.detach().double() - weights[n].double() for n, p in named.items()})


def _reference_step(weights, broken=None):
    """The reference's step in float64 from the same weights and batch."""
    b = _tensors(_batch())
    params = {n: w.double().requires_grad_() for n, w in weights.items()}
    if broken == "weights_bf16":
        params = {n: _bf16(w.detach()).requires_grad_() for n, w in params.items()}
    x = R.inputs(b, CONFIG)
    if broken == "inputs_bf16":
        x = _bf16(x)
    logp = R.forward(params, x, b["qmask"].double(), b["umask"].double())
    loss = common.masked_loss(logp, b["label"], b["umask"].double())
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    new = {n: p.detach().clone() for n, p in params.items()}
    common.adam_step(new, grads, {}, LR, DECAY)
    return (float(loss.detach()), grads, {n: new[n] - weights[n].double() for n in new})


def _worst(prog, ref):
    return max(float((prog[n] - ref[n]).norm() / ref[n].norm()) for n in ref)


@pytest.fixture(scope="module")
def step():
    weights = make_weights(R.param_table(6), 17, "cpu")
    return weights, _program_step(weights)


def test_train_step_is_the_references(step):
    weights, (loss, grads, changes) = step
    ref_loss, ref_grads, ref_changes = _reference_step(weights)
    assert grads.keys() == ref_grads.keys() == changes.keys()
    assert abs(loss - ref_loss) / ref_loss < LOSS_TOL
    assert _worst(grads, ref_grads) < GRAD_TOL
    assert _worst(changes, ref_changes) < CHANGE_TOL


@pytest.mark.parametrize("broken", ["inputs_bf16", "weights_bf16"])
def test_train_step_sees_a_broken_side(step, broken):
    weights, (loss, grads, changes) = step
    ref_loss, ref_grads, ref_changes = _reference_step(weights, broken)
    assert abs(loss - ref_loss) / ref_loss > LOSS_TOL
    assert _worst(grads, ref_grads) > GRAD_TOL
    assert _worst(changes, ref_changes) > CHANGE_TOL


@pytest.mark.parametrize("L_, B_", [(6, 5), (13, 3)])
@pytest.mark.parametrize("train", [False, True])
def test_matmul_flops_is_the_counters(L_, B_, train):
    # two shapes besides the two that benchmark/tests holds every reference at
    assert R.matmul_flops(L_, B_, train) == counted("DialogueRNN", L_, B_, train)
