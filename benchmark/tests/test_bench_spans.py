"""The readers of the program's spans: ``metrics/spans.py`` on a hand-built
trace, and each span metric read, and positive, in a small traced run of
each of its cells on the CPU, with every span of the slice inside it."""

import pytest
import torch

from benchmark.cell import HERE, Readings, benchmark_file, read_metric
from benchmark.metrics.spans import host_ms_per_item
from benchmark.run import execute
from benchmark.tests.small import small_cell
from benchmark.trace import Trace

SEED = 2 ** 31 + 7919
MS = 1_000_000  # ns
SPAN_METRICS = [m for m in benchmark_file()["per_layer"]
                if "host_ms_per_item" in (HERE / "metrics" / f"{m['name']}.py").read_text()]
ROOTS = {"train_epochs": "ser#train.step", "score_requests": "ser#request"}


def two_steps() -> Trace:
    """Two train steps of 40 ms, 10 ms apart, each with its spans nested as
    the program records them and a 0.1 ms kernel in its inputs, forward,
    recurrence, backward and Adam's step."""
    host, kernels = [], []
    for t0 in (0, 50 * MS):
        host += [("ser#train.step", t0, t0 + 40 * MS),
                 ("ser#inputs", t0, t0 + 2 * MS),
                 ("ser#forward", t0 + 2 * MS, t0 + 20 * MS),
                 ("ser#recurrence", t0 + 5 * MS, t0 + 18 * MS),
                 ("aten::mm", t0 + 6 * MS, t0 + 7 * MS),
                 ("ser#backward", t0 + 20 * MS, t0 + 36 * MS),
                 ("Optimizer.zero_grad#Adam.zero_grad", t0 + 2 * MS, t0 + 2 * MS),
                 ("Optimizer.step#Adam.step", t0 + 36 * MS, t0 + 39 * MS)]
        kernels += [("k", t0 + at * MS // 10, MS // 10) for at in (10, 40, 100, 250, 370)]
    return Trace(0, 100 * MS, kernels=kernels, host=host)


def test_spans_helper_on_a_hand_built_trace():
    run = Readings(trace=two_steps(), slice_shapes=[[110, 80], [103, 40]])
    assert host_ms_per_item(run, "ser#forward") == pytest.approx(18.0)
    assert host_ms_per_item(run, "ser#recurrence") == pytest.approx(13.0)
    assert host_ms_per_item(run, "ser#backward") == pytest.approx(16.0)
    assert host_ms_per_item(run, "ser#inputs") == pytest.approx(2.0)
    # a name ending in '#' is a prefix: Adam's step, not its zero_grad
    assert host_ms_per_item(run, "Optimizer.step#") == pytest.approx(3.0)
    assert host_ms_per_item(run, "ser#request") is None
    assert host_ms_per_item(Readings(slice_shapes=[[1, 1]]), "ser#forward") is None
    assert host_ms_per_item(Readings(trace=two_steps()), "ser#forward") is None


def test_idle_gaps_land_on_the_innermost_span():
    gaps = dict(two_steps().idle_gaps())
    # a gap goes to the innermost span open at its middle: the forward's kernel
    # to the recurrence's, and the recurrence's to the backward's
    assert gaps["ser#recurrence"] == pytest.approx(2 * (5.9e-3 + 14.9e-3))
    assert gaps["ser#backward"] == pytest.approx(2 * 11.9e-3)
    assert gaps["ser#inputs"] == pytest.approx(1e-3)
    # Adam's kernel to the next step's first, and the last to the slice's end
    assert gaps["(Python between ops)"] == pytest.approx(13.9e-3 + 12.9e-3)


@pytest.mark.parametrize("workload", [w["name"] for w in benchmark_file()["workloads"]])
def test_span_metrics_read_in_a_small_traced_run(workload, monkeypatch):
    cell = small_cell(workload)
    module = cell.driver
    traces = []
    profile = module.profile_slice
    monkeypatch.setattr(module, "profile_slice",
                        lambda torch, fn: traces.append(profile(torch, fn)) or traces[-1])
    result, _ = execute(cell, SEED, 0.2, 1, torch, "cpu")
    assert result["correct"], result["compared"]
    mine = [m["name"] for m in SPAN_METRICS if workload in m["workloads"]]
    assert mine
    for name in mine:
        assert result["metrics"][name]["value"] > 0, name
        assert result["metrics"][name]["unit"] == "ms"
    (trace,) = traces
    spans = [h for h in trace.host if "#" in h[0]]
    assert spans and all(trace.start <= s and e <= trace.end for _, s, e in spans)
    # one root span a step or a request: the count the readers divide by
    n_roots = sum(1 for n, *_ in spans if n == ROOTS[cell.traffic["driver"]])
    again = read_metric(mine[0], Readings(trace=trace, slice_shapes=[None] * n_roots))
    assert again == pytest.approx(result["metrics"][mine[0]]["value"])
