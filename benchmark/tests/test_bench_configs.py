"""Each configuration file against what runs: its widths as the reference's
parameter table and constants give them, and its dropout rates as the
program's model holds them, so that the file cannot drift from the cell."""

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
    table = {n: shape for n, (shape, _, _) in ref.param_table(config["classes"]).items()}
    modality, text = table["linear_in.weight"]
    assert (text, modality) == (config["text_width"], config["modality_width"]) == (ref.D_R, ref.D_M)
    assert table["encoder_a.slf_attn.w_qs.weight"][1] == config["audio_width"]
    assert config["input_width"] == config["text_width"] + config["audio_width"]
    four_h, hidden = table["marn_cell_f.lsthm_l.U.weight"]
    assert four_h == 4 * hidden and hidden == config["hidden"] == ref.H
    enc = config["encoder"]
    assert {k: enc[k] for k in ref.ENC} == ref.ENC
    for side in ("encoder_l", "encoder_a"):
        assert table[f"{side}.slf_attn.w_qs.weight"] == (enc["n_head"] * enc["d_k"], enc["d_model"])
        assert table[f"{side}.slf_attn.w_vs.weight"] == (enc["n_head"] * enc["d_v"], enc["d_model"])
        assert table[f"{side}.pos_ffn.w_1.weight"] == (enc["d_inner"], enc["d_model"])
    d_hidden, d_feat = table["nn_out.0.weight"]
    assert [d_feat, d_hidden, table["nn_out.3.weight"][0]] == config["head"]
    assert config["head"][-1] == config["classes"]


@pytest.mark.parametrize("name", CONFIGS)
def test_encoder_passes_are_the_references(name, monkeypatch):
    # each encoder layer runs ``passes`` times in the reference's forward
    from benchmark.reference import common
    from benchmark.weights import make_weights

    config, ref = config_and_reference(name)
    calls, encoder = [], common.encoder
    monkeypatch.setattr(common, "encoder", lambda P, n, *a, **k: calls.append(n) or encoder(
        P, n, *a, **k))
    L, B = 3, 2
    x = torch.zeros(L, B, config["input_width"])
    qmask = torch.zeros(L, B, config["parties"])
    qmask[..., 0] = 1
    ref.forward(make_weights(ref.param_table(config["classes"]), 0, "cpu"), x, qmask,
                torch.ones(B, L))
    assert calls.count("encoder_l") == calls.count("encoder_a") == config["encoder"]["passes"]


def dropout_group(module: str) -> str:
    """The configuration's dropout key of a program module's rate."""
    if "encoder_" in module:
        return "encoder"
    if "crossatt" in module:
        return "sequence_attention"
    if module.endswith("attn_dropout"):
        return "rank1_attention"
    if module.startswith(("nn_out.", "fc.")):
        return "head"
    return "recurrence"


@pytest.mark.parametrize("name", CONFIGS)
def test_dropout_is_the_programs(name):
    from ser_tpu_torch.models.registry import build_model
    from ser_tpu_torch.ops.init import generator

    config, _ = config_and_reference(name)
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
        assert p == config["dropout"][dropout_group(module_name)], module_name
    assert {dropout_group(n) for n in rates} == set(config["dropout"])
