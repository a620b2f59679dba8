"""Each reference's FLOP formula against FlopCounterMode on the reference
itself, at shapes the formulas were not fitted on, and against the
program's own count of its plain path (only this test imports both)."""

import importlib

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.cell import ROOT, benchmark_file, load_json
from benchmark.reference import common
from benchmark.weights import make_weights

# each configuration's reference name -> (its reference module, the configuration)
REFERENCES = {cfg["reference"]: (importlib.import_module(f"benchmark.reference.{cfg['reference']}"),
                                 cfg)
              for cfg in (load_json(ROOT / c["file"]) for c in benchmark_file()["configs"])}
MARN1 = [name for name in REFERENCES if name.startswith("MARN1_")]


def inputs(L, B, config, seed=0):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, L + 1, size=B)
    lengths[0] = L
    umask = (np.arange(L)[None] < lengths[:, None]).astype(np.float32)
    P = config["parties"]
    qmask = np.zeros((L, B, P), np.float32)
    qmask[np.arange(L)[:, None], np.arange(B)[None], rng.integers(0, P, (L, B))] = 1
    qmask *= umask.T[..., None]
    x = (rng.standard_normal((L, B, config["input_width"])).astype(np.float32)
         * umask.T[..., None])
    labels = rng.integers(0, config["classes"], (B, L))
    return [torch.as_tensor(a) for a in (x, qmask, umask, labels)]


def counted(name, L, B, train):
    ref, config = REFERENCES[name]
    weights = make_weights(ref.param_table(config["classes"]), 0, "cpu")
    x, qmask, umask, labels = inputs(L, B, config)
    params = {n: w.requires_grad_(train) for n, w in weights.items()}
    with FlopCounterMode(display=False) as counter:
        logp = ref.forward(params, x, qmask, umask)
        if train:
            loss = common.masked_loss(logp, labels, umask)
            torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return counter.get_total_flops()


@pytest.mark.parametrize("name", REFERENCES)
@pytest.mark.parametrize("L, B", [(4, 3), (10, 2)])
@pytest.mark.parametrize("train", [False, True])
def test_formula_is_the_counters(name, L, B, train):
    assert REFERENCES[name][0].matmul_flops(L, B, train) == counted(name, L, B, train)


def test_onlysp_matches_the_programs_counts():
    # the program's own counts of its plain path at the bench shapes
    onlysp = REFERENCES["MARN1_onlysp"][0]
    assert onlysp.matmul_flops(82, 31, False) == 12_166_134_016
    assert onlysp.matmul_flops(110, 80, True) == 128_133_591_040


@pytest.mark.parametrize("name", MARN1)
def test_program_counts_the_same_eval(name):
    from ser_tpu_torch.models.registry import build_model
    from ser_tpu_torch.ops.init import generator
    from ser_tpu_torch.utils.flops import count_flops

    ref, config = REFERENCES[name]
    model = build_model(config["model"], generator(0)).eval()
    x, qmask, umask, _ = inputs(6, 3, config)
    with torch.no_grad():
        assert count_flops(model, x, qmask, umask) == ref.matmul_flops(6, 3, False)

