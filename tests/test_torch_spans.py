"""The program's spans (``utils/profiling.py``) on the CPU: under
``torch.profiler`` a train step of MARN1_onlysp, of MARN1_nsps and of
DialogueRNN and a scoring request record each of their spans once, nested
as the layers are; the numbers are bit-equal with the profiler on and off;
with no profiler ``annotate`` is one shared null context; and every span
name carries ``#``, which marks the profiler's device-side copy of a span
as an annotation, not a kernel. Tiny shapes at full model width, one
intra-op thread."""

import contextlib
import re
from pathlib import Path

import pytest
import torch

from ser_tpu_torch.data.synthetic import synthetic_batch
from ser_tpu_torch.serving import Predictor
from ser_tpu_torch.train.trainer import ModelTrainer
from ser_tpu_torch.utils import profiling

MODELS = ("MARN1_onlysp", "MARN1_nsps", "DialogueRNN")
ADAM = "Optimizer.step#Adam.step"
L, B = 7, 3
PACKAGE = Path(__file__).resolve().parent.parent / "ser_tpu_torch"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed=3):
    return synthetic_batch(L=L, B=B, seed=seed, min_len=3)


def _outermost(records):
    """The records that lie inside no other of the list."""
    kept = []
    for r in sorted(records, key=lambda r: (r[0], -r[1])):
        if not kept or r[0] >= kept[-1][1]:
            kept.append(r)
    return kept


def _profiled(fn):
    """``(fn()'s result, {span name: [(start, end), ...]})`` for the
    program's spans and Adam's, from the profiler's own records. Adam's
    step is torch's range, not the program's: once a plain
    ``torch.optim.Adam`` has been built in the process, torch wraps that
    class's ``step`` too, and the program's subclass then records a second
    range of the same name inside its own. Only its outermost ranges
    count."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in profiling.SPANS or e.name() == ADAM:
            spans.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    if ADAM in spans:
        spans[ADAM] = _outermost(spans[ADAM])
    return out, spans


def _within(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


@pytest.fixture(scope="module")
def steps():
    """model -> the same first train step of two trainers built from one
    seed, the profiler off for the first and on for the second: ``(loss,
    grads)`` of each and the second's spans."""
    out = {}
    for name in MODELS:
        runs = []
        for profile in (False, True):
            trainer = ModelTrainer(device="cpu", model=name, seed=11)

            def step():
                loss = trainer._train_step_impl(_batch(), 1e-3)
                return loss, {n: p.grad.clone() for n, p in trainer.model.named_parameters()
                              if p.grad is not None}
            runs.append(_profiled(step) if profile else (step(), None))
        out[name] = runs
    return out


@pytest.mark.parametrize("name", MODELS)
def test_train_step_records_each_span_once_nested(steps, name):
    spans = steps[name][1][1]
    assert set(spans) == {"ser#train.step", "ser#inputs", "ser#forward", "ser#recurrence",
                          "ser#backward", ADAM}
    assert all(len(v) == 1 for v in spans.values()), spans
    one = {k: v[0] for k, v in spans.items()}
    root = one["ser#train.step"]
    for child in ("ser#inputs", "ser#forward", "ser#backward", ADAM):
        assert _within(one[child], root), child
    assert _within(one["ser#recurrence"], one["ser#forward"])
    # the step's layers in their order, none inside another
    order = [one[k] for k in ("ser#inputs", "ser#forward", "ser#backward", ADAM)]
    assert all(a[1] <= b[0] for a, b in zip(order, order[1:]))


@pytest.mark.parametrize("name", MODELS)
def test_train_step_is_bit_equal_with_the_profiler_on(steps, name):
    (loss_off, grads_off), _ = steps[name][0]
    (loss_on, grads_on), _ = steps[name][1]
    assert torch.equal(loss_off, loss_on)
    assert grads_off.keys() == grads_on.keys() and grads_off
    assert all(torch.equal(grads_off[n], grads_on[n]) for n in grads_off)


@pytest.mark.parametrize("name", MODELS)
def test_request_records_each_span_once_nested_and_bit_equal(name):
    predictor = Predictor(name, seed=5, device="cpu")
    logp_off, labels_off = predictor.predict_batch(_batch(7))
    (logp_on, labels_on), spans = _profiled(lambda: predictor.predict_batch(_batch(7)))
    assert torch.equal(logp_off, logp_on) and torch.equal(labels_off, labels_on)
    assert set(spans) == {"ser#request", "ser#inputs", "ser#forward", "ser#recurrence"}
    assert all(len(v) == 1 for v in spans.values()), spans
    one = {k: v[0] for k, v in spans.items()}
    assert _within(one["ser#inputs"], one["ser#request"])
    assert _within(one["ser#forward"], one["ser#request"])
    assert _within(one["ser#recurrence"], one["ser#forward"])
    assert one["ser#inputs"][1] <= one["ser#forward"][0]


def test_annotate_without_a_profiler_is_the_shared_null_context():
    first = profiling.annotate("ser#forward")
    assert isinstance(first, contextlib.nullcontext)
    assert all(profiling.annotate(n) is first for n in profiling.SPANS)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert isinstance(profiling.annotate("ser#forward"), torch.profiler.record_function)
    assert profiling.annotate("ser#forward") is first


def test_every_span_name_marks_an_annotation_and_is_used():
    assert profiling.SPANS and all("#" in n for n in profiling.SPANS)
    assert len(set(profiling.SPANS)) == len(profiling.SPANS)
    used = {m for path in PACKAGE.rglob("*.py")
            for m in re.findall(r'annotate\("([^"]+)"\)', path.read_text())}
    assert used == set(profiling.SPANS)
