"""Whole runs of each cell on the CPU at small sizes, past the harness's
look for a card: a sound run is correct, and each fault that the cell can
have, planted under the timed path, makes it not correct. The control
(TF32) needs the card."""

import json
import subprocess
import sys

import pytest
import torch

from benchmark import faults
from benchmark.cell import ROOT, benchmark_file
from benchmark.run import execute
from benchmark.tests.small import small_cell

SEED = 2 ** 31 + 4099
WORKLOADS = [w["name"] for w in benchmark_file()["workloads"]]
TRAIN = [w for w in WORKLOADS if ".train." in w]
SCORE = [w for w in WORKLOADS if ".score." in w]
KEYS = ["correct", "attempted", "failed", "metrics", "device", "compared"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_sound_run_is_correct(workload):
    cell = small_cell(workload)
    result, _ = execute(cell, SEED, 0.2, 0, torch, "cpu")
    assert list(result) == KEYS
    assert result["correct"], result["compared"]
    assert set(result["compared"]) == set(cell.limits)
    assert result["failed"] == 0 and result["attempted"] > 0
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}


@pytest.mark.parametrize("workload", WORKLOADS)
def test_traced_run_keys(workload):
    cell = small_cell(workload)
    result, _ = execute(cell, SEED + 1, 0.2, 1, torch, "cpu")
    assert list(result) == KEYS[:5] + ["breakdown", "compared"]
    assert result["correct"]
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    # no device records on the CPU: no device metric is read from them
    assert not any(m in result["metrics"] for m in
                   ("train.launches_per_step", "score.launches_per_request",
                    "rank1.roofline_pct.score", "rank1.roofline_pct.train"))


@pytest.mark.parametrize("workload, fault", [(w, f) for w in TRAIN for f in faults.TRAIN]
                         + [(w, f) for w in SCORE for f in faults.SCORE])
def test_planted_fault_is_not_correct(workload, fault):
    plant = {**faults.TRAIN, **faults.SCORE}[fault]
    result, _ = execute(small_cell(workload), SEED + 2, 0.2, 0, torch, "cpu", plant=plant)
    assert not result["correct"], result["compared"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_tf32_control_is_not_correct(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: TF32 exists only on the card")
    result, _ = execute(small_cell(workload), SEED + 3, 0.5, 0, torch, "cuda", tf32=True)
    assert not result["correct"], result["compared"]


def test_run_loads_no_jax():
    # a whole small run in a fresh process, then its modules by top-level name
    code = ("import json, sys, torch\n"
            "from benchmark.run import execute, loaded_forbidden\n"
            "from benchmark.tests.small import small_cell\n"
            f"execute(small_cell({SCORE[0]!r}), 5, 0.1, 0, torch, 'cpu')\n"
            "print(json.dumps(loaded_forbidden()))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_cli_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", WORKLOADS[0],
                          "--seed", "1", "--seconds", "1"], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
