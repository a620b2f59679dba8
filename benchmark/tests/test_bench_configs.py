"""Each configuration file against what runs: its widths as the reference's
parameter table and constants give them, and its dropout rates as the
program's model holds them, so that the file cannot drift from the cell.
The rules are the reference module's own (``config_checks``,
``dropout_group``, ``ENCODERS``), so a family brings its own."""

import pytest
import torch

from benchmark.cell import ROOT, benchmark_file, load_cell, load_json

CONFIGS = {c["name"]: c for c in benchmark_file()["configs"]}


def config_and_reference(name):
    config = load_json(ROOT / CONFIGS[name]["file"])
    workload = next(w["name"] for w in benchmark_file()["workloads"] if w["config"] == name)
    return config, load_cell(workload).reference


@pytest.mark.parametrize("name", CONFIGS)
def test_widths_are_the_references(name):
    config, ref = config_and_reference(name)
    checks = ref.config_checks(config)
    assert checks
    for what, one, other in checks:
        assert one == other, what


@pytest.mark.parametrize("name", CONFIGS)
def test_encoder_passes_are_the_references(name, monkeypatch):
    # each encoder layer that the reference declares runs ``passes`` times in
    # its forward, and a reference that declares none runs no encoder
    from benchmark.reference import common
    from benchmark.weights import make_weights

    config, ref = config_and_reference(name)
    encoders = getattr(ref, "ENCODERS", ())
    calls, encoder = [], common.encoder
    monkeypatch.setattr(common, "encoder", lambda P, n, *a, **k: calls.append(n) or encoder(
        P, n, *a, **k))
    L, B = 3, 2
    x = torch.zeros(L, B, config["input_width"])
    qmask = torch.zeros(L, B, config["parties"])
    qmask[..., 0] = 1
    ref.forward(make_weights(ref.param_table(config["classes"]), 0, "cpu"), x, qmask,
                torch.ones(B, L))
    assert set(calls) == set(encoders)
    for side in encoders:
        assert calls.count(side) == config["encoder"]["passes"], side


@pytest.mark.parametrize("name", CONFIGS)
def test_dropout_is_the_programs(name):
    from ser_tpu_torch.models.registry import build_model
    from ser_tpu_torch.ops.init import generator

    config, ref = config_and_reference(name)
    model = build_model(config["model"], generator(0))
    rates = {}
    for module_name, m in model.named_modules():
        if type(m).__name__ == "Dropout":
            rates[module_name] = m.p
        for attr in ("dropout_rate", "attn_dropout"):
            if isinstance(getattr(m, attr, None), float):
                rates[f"{module_name}.{attr}"] = getattr(m, attr)
    assert rates
    for module_name, p in rates.items():
        assert p == config["dropout"][ref.dropout_group(module_name)], module_name
    assert {ref.dropout_group(n) for n in rates} == set(config["dropout"])
