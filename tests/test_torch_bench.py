"""The port's bench CLIs (``python -m ser_tpu_torch.bench`` and
``bench_zoo``) against the JAX ``bench.py`` and ``bench_zoo.py``, on the CPU.

The JAX scripts' keys are read from their source (the dicts they print and
return), not run: their timing loops need the TPU. Both port CLIs run with
``--device cpu`` on tiny workloads (eval [6, 3], train [6, 2], waveforms
[4, 400]), one window a timing and no least window time, so the file stays
cheap; the numbers are CPU numbers and only their keys, signs and ratios
are checked. The card runs the CLIs at full size in ``chip_smoke.py``
phase 19.
"""

import ast
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import bench
from ser_tpu.utils.flops import efficiency as jefficiency
from ser_tpu_torch import bench as tbench
from ser_tpu_torch import bench_zoo
from ser_tpu_torch.data import synthetic
from ser_tpu_torch.utils.flops import efficiency

ROOT = Path(__file__).resolve().parent.parent
TORCH_CPU_VALUE = 1776.297489560712  # baselines/torch_cpu.json


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_printed_dicts(path):
    """Every dict literal in ``path``'s source, as {key: value node}."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Dict):
            yield {k.value: v for k, v in zip(node.keys, node.values)
                   if isinstance(k, ast.Constant)}


def _jax_bench_keys():
    """``bench.py``'s line keys, its ``detail`` keys and its error line's keys."""
    dicts = list(_jax_printed_dicts(ROOT / "bench.py"))
    line = next(d for d in dicts if "metric" in d and "detail" in d)
    error = next(d for d in dicts if "error" in d)
    detail = [k.value for k in line["detail"].keys]
    return list(line), detail, list(error)


def _jax_zoo_keys(fn_name):
    """The keys ``bench_zoo.py::fn_name`` returns, the efficiency keys last."""
    tree = ast.parse((ROOT / "bench_zoo.py").read_text())
    fn = next(f for f in tree.body if isinstance(f, ast.FunctionDef) and f.name == fn_name)
    ret = next(n for n in ast.walk(fn) if isinstance(n, ast.Return)
               and isinstance(n.value, ast.Dict))
    keys = [k.value for k in ret.value.keys if k is not None]
    return keys + list(jefficiency(1e9, 1.0))


def _eval_batch(seed=0):
    batch = synthetic.synthetic_batch(L=6, B=3, seed=seed + 1)
    return batch, int(batch["umask"].sum())


@pytest.fixture
def tiny(monkeypatch, tmp_path):
    """Tiny workloads, one window a timing, no least window time, and no
    zoo baseline."""
    monkeypatch.setattr(tbench, "iemocap_eval_batch", _eval_batch)
    monkeypatch.setattr(tbench, "synthetic_like_train", lambda seed=1: synthetic.synthetic_batch(
        L=6, B=2, seed=seed, min_len=2))
    monkeypatch.setattr(tbench, "wav_batch", lambda n: np.random.default_rng(3).standard_normal(
        (4, 400)).astype(np.float32))
    monkeypatch.setattr(tbench, "EVAL_WINDOW_S", 0.0)
    monkeypatch.setattr(tbench, "TRAIN_WINDOW_S", 0.0)
    monkeypatch.setattr(tbench, "WINDOWS", 1)
    monkeypatch.setattr(tbench, "QUIET_WAIT_S", 0.0)
    monkeypatch.setattr(tbench, "ZOO_BASELINE", tmp_path / "zoo_h100.json")
    return tmp_path


def _run(main, argv, capsys):
    """``main(argv)``: its exit code and its standard output's lines."""
    code = main(argv)
    return code, capsys.readouterr().out.strip().splitlines()


def _timed(monkeypatch):
    """The names of the functions ``tbench.time_calls`` times, in order."""
    names = []
    time_calls = tbench.time_calls

    def recording(fn, *args, **kwargs):
        names.append(fn.__name__)
        return time_calls(fn, *args, **kwargs)

    monkeypatch.setattr(tbench, "time_calls", recording)
    return names


def test_train_workload_equals_the_jax_benchs():
    ours, theirs = synthetic.synthetic_like_train(1), bench.synthetic_like_train(1)
    assert sorted(ours) == sorted(theirs)
    assert ours["r1"].shape[:2] == (110, 80)
    for k in ours:
        np.testing.assert_array_equal(np.asarray(ours[k]), np.asarray(theirs[k]))


def test_bench_line_has_the_jax_keys(tiny, capsys):
    code, lines = _run(tbench.main, ["--device", "cpu"], capsys)
    assert code == 0 and len(lines) == 1  # one line: the trainers print to stderr
    line = json.loads(lines[0])
    keys, detail_keys, _ = _jax_bench_keys()
    assert list(line) == keys and list(line["detail"]) == detail_keys
    d = line["detail"]
    assert d["backend"] == d["device"] == "cpu" and d["train_shape"] == [6, 2]
    assert line["noisy"] is False and d["flagship_vs_zoo_baseline"] is None
    assert d["n_utterances"] == _eval_batch()[1]
    numbers = [line["value"], line["vs_baseline"], d["seconds_per_pass"], d["n_utterances"],
               d["train_utterances_per_sec"], d["train_seconds_per_step"],
               d["mfcc_frontend_utterances_per_sec"], d["mfcc_frontend_wav_seconds_per_utt"]]
    assert all(math.isfinite(x) and x > 0 for x in numbers)
    assert d["mfcc_frontend_wav_seconds_per_utt"] == 400 / 16000
    assert line["value"] == round(d["n_utterances"] / d["seconds_per_pass"], 1)
    assert line["vs_baseline"] == pytest.approx(line["value"] / TORCH_CPU_VALUE, abs=0.0051)
    # the shares are rounded (tiny passes on the CPU round to 0): each is
    # efficiency() of its own FLOPs and seconds, the FLOPs positive
    for k, sec in (("eval_efficiency", d["seconds_per_pass"]),
                   ("train_efficiency", d["train_seconds_per_step"])):
        assert list(d[k]) == list(jefficiency(1e9, 1.0))
        assert d[k]["flops_per_pass"] > 0 and d[k] == efficiency(d[k]["flops_per_pass"], sec)


@pytest.mark.parametrize("backend, reference, want", [
    ("cuda", 1.0, None),  # recorded on another backend: not read
    ("cpu", 1e-3, False),  # the run is faster: read once, not noisy
    ("cpu", 1e12, True),  # slower: measured again after the pause, noisy
])
def test_bench_reads_the_zoo_baseline_of_its_own_backend(tiny, monkeypatch, capsys,
                                                         backend, reference, want):
    tbench.ZOO_BASELINE.write_text(json.dumps({"backend": backend, "models": {
        "MARN1_onlysp": {"utterances_per_sec": reference}}}))
    timed = _timed(monkeypatch)
    code, lines = _run(tbench.main, ["--device", "cpu"], capsys)
    line = json.loads(lines[-1])
    vs_zoo = line["detail"]["flagship_vs_zoo_baseline"]
    if want is None:
        assert vs_zoo is None and line["noisy"] is False
    else:
        d = line["detail"]
        assert vs_zoo == round(d["n_utterances"] / d["seconds_per_pass"] / reference, 3)
        assert line["noisy"] is want
    retaken = ["eval_pass"] if want else []
    assert code == 0 and timed == ["eval_pass", "train_step", "frontend_pass", *retaken]


def test_no_cuda_gives_the_error_line_and_exit_1(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    code, lines = _run(tbench.main, [], capsys)
    line = json.loads(lines[-1])
    assert code == 1 and len(lines) == 1 and list(line) == _jax_bench_keys()[2]
    assert line["value"] == 0.0 and "CUDA is not available" in line["error"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench_zoo.main(["--models", "MARN1_onlysp"])
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("iters, window, cap, k", [
    (1, 0.0, 2000, 1),  # no least window time: K = iters
    (3, 0.0, 2000, 3),
    (1, 10.0, 4, 4),  # a window that would last 10 s is capped
])
def test_time_calls_counts_its_calls(monkeypatch, iters, window, cap, k):
    n = []
    t = tbench.time_calls(lambda: n.append(1), torch.device("cpu"), window, iters, cap)
    assert t.calls == len(n) == 1 + iters + tbench.WINDOWS * k
    assert t.first_s >= 0 and t.seconds >= 0


def test_time_calls_grows_a_window_to_its_least_time():
    import time

    t = tbench.time_calls(lambda: time.sleep(0.002), torch.device("cpu"), 0.02, 1)
    k = (t.calls - 2) // tbench.WINDOWS
    assert t.calls == 2 + tbench.WINDOWS * k and 2 <= k <= 10
    assert 0.002 <= t.seconds < 0.02


@pytest.mark.parametrize("argv, fn_name", [
    ([], "bench_model"),
    (["--train"], "bench_model_train"),
])
def test_bench_zoo_gives_the_jax_keys(tiny, monkeypatch, capsys, argv, fn_name):
    classes = {}
    train_step_of = tbench.train_step_of

    def recording(name, *args, **kwargs):
        classes[name] = kwargs["n_classes"]
        return train_step_of(name, *args, **kwargs)

    monkeypatch.setattr(tbench, "train_step_of", recording)
    models = ["MARN1_onlysp", "DialogueRNN", "MARN_AT"]
    code, lines = _run(bench_zoo.main, ["--device", "cpu", "--iters", "2", "--models",
                                        *models, *argv], capsys)
    assert code == 0
    per_model = [json.loads(x) for x in lines[:3]]
    assert [list(r) for r in per_model] == [[m] for m in models]
    everything = json.loads("\n".join(lines[3:]))["all"]
    keys = _jax_zoo_keys(fn_name)
    for m, r in zip(models, per_model):
        assert list(r[m]) == keys and r[m] == everything[m]
        assert all(math.isfinite(v) and v >= 0 for v in r[m].values())
        assert r[m]["utterances_per_sec"] > 0 and r[m]["flops_per_pass"] > 0
    # MARN_AT trains with 7 classes, as the JAX script's
    assert classes == ({"MARN1_onlysp": 6, "DialogueRNN": 6, "MARN_AT": 7} if argv else {})


def test_bench_zoo_trains_in_bf16(tiny, monkeypatch, capsys):
    dtypes = []
    train_step_of = tbench.train_step_of

    def recording(name, batch, device, compute_dtype="f32", **kwargs):
        dtypes.append(compute_dtype)
        return train_step_of(name, batch, device, compute_dtype, **kwargs)

    monkeypatch.setattr(tbench, "train_step_of", recording)
    code, lines = _run(bench_zoo.main, ["--device", "cpu", "--train", "--dtype", "bf16",
                                        "--models", "MARN1_onlysp"], capsys)
    res = json.loads(lines[0])["MARN1_onlysp"]
    assert code == 0 and dtypes == ["bf16"]
    assert list(res) == _jax_zoo_keys("bench_model_train") and res["ms_per_step"] > 0


def test_bench_zoo_save_then_check(tiny, capsys):
    path = tiny / "zoo.json"
    argv = ["--device", "cpu", "--models", "MARN1_onlysp", "--iters", "1"]
    code, lines = _run(bench_zoo.main, argv + ["--save", str(path)], capsys)
    doc = json.loads(path.read_text())
    assert code == 0 and list(doc) == ["backend", "device", "n_utterances", "dtype", "models"]
    assert (doc["backend"], doc["device"], doc["dtype"]) == ("cpu", "cpu", "f32")
    assert doc["n_utterances"] == _eval_batch()[1] and list(doc["models"]) == ["MARN1_onlysp"]
    # the round trip (a threshold far below the CPU's spread between two runs)
    code, lines = _run(bench_zoo.main, argv + ["--check", str(path), "--check_threshold",
                                               "0.01"], capsys)
    assert code == 0 and sum(x.startswith("MARN1_onlysp: ") for x in lines) == 1
    # a baseline the run cannot reach is a regression
    doc["models"]["MARN1_onlysp"]["utterances_per_sec"] = 1e12
    path.write_text(json.dumps(doc))
    with pytest.raises(SystemExit, match="throughput regressions"):
        bench_zoo.main(argv + ["--check", str(path)])


@pytest.mark.parametrize("case", ["tpu", "dtype", "bf16_eval"])
def test_bench_zoo_refusals(tiny, monkeypatch, case):
    monkeypatch.setattr(tbench, "eval_pass_of", lambda *a: pytest.fail("a model ran"))
    monkeypatch.setattr(tbench, "train_step_of", lambda *a, **k: pytest.fail("a model ran"))
    argv = ["--device", "cpu", "--models", "MARN1_onlysp"]
    if case == "tpu":  # the TPU's figures are no yardstick for the port
        argv += ["--check", str(ROOT / "baselines" / "zoo_r04.json")]
        match = "backend 'tpu'"
    elif case == "dtype":
        path = tiny / "bf16.json"
        path.write_text(json.dumps({"backend": "cpu", "dtype": "bf16", "models": {}}))
        argv += ["--check", str(path)]
        match = "dtype=bf16"
    else:
        argv += ["--dtype", "bf16"]
        match = "applies to --train"
    with pytest.raises(SystemExit, match=match):
        bench_zoo.main(argv)


@pytest.mark.parametrize("failures, code", [(1, 0), (2, 1)])
def test_bench_zoo_retries_a_failing_model_once(tiny, monkeypatch, capsys, failures, code):
    left = {"MARN1_cf": failures}

    def flaky(name, *args):
        if left.get(name):
            left[name] -= 1
            raise RuntimeError(f"{name} failed")
        return {"ms_per_pass": 1.0, "utterances_per_sec": 1.0, "compile_s": 1.0}

    monkeypatch.setattr(bench_zoo, "bench_model", flaky)
    path = tiny / "zoo.json"
    got, lines = _run(bench_zoo.main, ["--device", "cpu", "--models", "MARN1_onlysp",
                                       "MARN1_cf", "--save", str(path)], capsys)
    retries = [json.loads(x) for x in lines if '"retrying"' in x]
    assert got == code and retries == [{"MARN1_cf": {"error": "RuntimeError: MARN1_cf failed"},
                                        "retrying": True}]
    final = [json.loads(x)["MARN1_cf"] for x in lines
             if x.startswith('{"MARN1_cf"') and '"retrying"' not in x]
    # an error left after the retry: its line, exit 1, nothing saved
    assert len(final) == 1 and ("error" in final[0]) is bool(code)
    assert path.exists() is (code == 0)
