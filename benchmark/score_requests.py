"""The score-requests driver: ``Predictor.predict_batch(batch)`` on whole
test splits, one caller, closed loop.

Set-up: a pool of requests (the traffic's ``pool``), each one synthetic
test split padded to its longest dialogue, the weights from the seed on the
card, the predictor with them, and a warm-up of ``warmup_requests``. The
window cycles through the pool until ``seconds`` have passed; a request is
timed from its send until its log-probabilities and labels are on the host,
and the window ends when the last one is. A traced run then profiles
``trace_requests`` more. Last, with the predictor freed, the reference
answers each request of the pool in float64, and every answer of the
window is compared with its request's (``compare.score_gaps``).
"""

from __future__ import annotations

import gc
import time

import numpy as np

from benchmark import compare, generate
from benchmark.cell import Outcome, Readings, rate_by_thirds
from benchmark.reference import common
from benchmark.trace import profile_slice
from benchmark.train_epochs import sub_seed
from benchmark.weights import make_weights


def data(cell, seed: int) -> list[dict]:
    """The run's pool of requests: the traffic's ``pool`` test splits of
    the same lengths, in orders and with features that ``seed`` draws."""
    tr = cell.traffic
    rng = np.random.default_rng([int(seed), 1])
    return generate.requests(generate.split_lengths(tr), cell.config, tr["pool"], rng)


def reference_answers(torch, cell, weights, pool, device) -> dict:
    """pool index -> the reference's log-probabilities, float64 on the host."""
    params = {n: w.to(device, torch.float64) for n, w in weights.items()}
    out = {}
    with torch.no_grad():
        for k, batch in enumerate(pool):
            b = {n: torch.as_tensor(v, device=device) for n, v in batch.items()}
            out[k] = cell.reference.forward(params, common.reference_input(cell, b),
                                            b["qmask"].double(), b["umask"].double()).cpu().numpy()
    return out


def run(cell, seed: int, seconds: float, trace: bool, ctx) -> Outcome:
    torch, device = ctx.torch, ctx.device
    from ser_tpu_torch.serving import Predictor

    cfg, tr = cell.config, cell.traffic
    pool = data(cell, seed)
    ctx.phase("data")
    weights = make_weights(cell.reference.param_table(cfg["classes"]), sub_seed(seed, 2), device)
    predictor = Predictor(cfg["model"], state_dict=weights, device=device,
                          n_classes=cfg["classes"])
    ctx.phase("program")
    ctx.plant(predictor)

    def ask(k):
        logp, labels = predictor.predict_batch(pool[k])
        return logp.cpu().numpy(), labels.cpu().numpy()

    for i in range(tr["warmup_requests"]):
        ask(i % len(pool))
    ctx.synchronize()
    setup_peak = ctx.memory_peak(reset=True)
    ctx.window_opens()

    answers, latencies, ends, i = [], [], [], 0
    t0 = time.perf_counter()
    while True:
        k = i % len(pool)
        sent = time.perf_counter()
        logp, labels = ask(k)
        done = time.perf_counter()
        latencies.append(done - sent)
        ends.append(done - t0)
        answers.append((k, logp, labels, pool[k]["umask"]))
        i += 1
        if done - t0 >= seconds:
            break
    elapsed = done - t0
    ctx.window_closes()
    shape = [generate.shape_of(pool[n % len(pool)]) for n in range(i)]
    readings = Readings(timed_shapes=shape, timed_s=elapsed, reference=cell.reference,
                        config=cfg, on_device=ctx.on_device)
    if trace:
        traced = [(i + n) % len(pool) for n in range(tr["trace_requests"])]
        got = []
        readings.trace = profile_slice(torch, lambda: got.extend(ask(k) for k in traced))
        answers.extend((k, *a, pool[k]["umask"]) for k, a in zip(traced, got))
        readings.slice_shapes = [generate.shape_of(pool[k]) for k in traced]
    window_peak = ctx.memory_peak()
    readings.reserved_peak_bytes = ctx.reserved_peak()

    del predictor
    gc.collect()
    ctx.free()
    compared, failed = compare.score_gaps(
        answers, reference_answers(torch, cell, weights, pool, device))
    utts = sum(generate.valid_utterances(pool[k]) for k, *_ in answers[:i])
    e2e = {"score_utts_per_s": utts / elapsed,
           "request_p95_ms": 1e3 * float(np.percentile(latencies, 95))}
    return Outcome(e2e, readings, len(answers), failed, compared,
                   max(setup_peak, window_peak),
                   {"thirds": rate_by_thirds(ends, utts / i)})
