"""The port's user-level scripts (``ser_tpu_torch/scripts/``) against the
repository's ``scripts/``, on the CPU.

- ``convergence_bf16``: one epoch, one seed of MARN1_onlysp in f32 and bf16
  on a few tiny dialogues; the document's top-level keys are those of
  ``PERF_convergence_r05.json`` (the JAX script's output, read, not run),
  and its model's key tree is each of that file's models'.
- ``compare_artifacts``: three JAX ``SER2`` v3 artifacts (f32, bf16, int8)
  of one MARN1_onlysp at bucket [12, 4]. The JAX script run on them gives
  the report's keys, model, shape and baseline. The figures come from each
  package's own serving: the JAX package runs a bf16 artifact's whole
  forward in bf16, the port under bf16 autocast (``serving.py``), and two
  bf16 forwards part by far more than 1e-4. So the port's figures are held
  to the JAX script's code run on the port's ``ServingModel``
  (``ser_tpu.serving.ServingModel`` stood in for): within 1e-4, the argmax
  agreement equal.
"""

import contextlib
import importlib.util
import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import ser_tpu.serving as jserving
from ser_tpu.serving import save_model as jsave_model
from ser_tpu_torch.compat.from_jax import to_jax_params
from ser_tpu_torch.scripts import compare_artifacts, convergence_bf16
from ser_tpu_torch.serving import Predictor, ServingModel, save_model

ROOT = Path(__file__).resolve().parent.parent
L, B = 12, 4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _key_tree(x):
    """A document's keys, nested; a list is the key tree its members share."""
    if isinstance(x, dict):
        return {k: _key_tree(v) for k, v in x.items()}
    if isinstance(x, list):
        trees = [_key_tree(v) for v in x]
        assert all(t == trees[0] for t in trees)
        return [trees[0]]
    return None


def _run(fn, argv):
    """``fn(argv)``'s last printed line as JSON, and its printed lines."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(argv)
    lines = buf.getvalue().splitlines()
    return json.loads(lines[-1]), lines


def test_convergence_document_has_the_jax_runs_keys(monkeypatch, tmp_path):
    monkeypatch.setattr(convergence_bf16, "DATA",
                        dict(n_train=8, n_test=4, min_len=4, max_len=8, seed=7))
    out = tmp_path / "conv.json"
    summary, lines = _run(convergence_bf16.main, [
        "--models", "MARN1_onlysp", "--seeds", "1", "--epochs", "1", "--device", "cpu",
        "--out", str(out)])
    doc = json.loads(out.read_text())
    jax_doc = json.loads((ROOT / "PERF_convergence_r05.json").read_text())
    assert doc.keys() == jax_doc.keys()
    assert (doc["backend"], doc["epochs"], doc["seeds"], doc["n_train"]) == ("cpu", 1, 1, 8)
    assert list(doc["models"]) == ["MARN1_onlysp"]
    for model in jax_doc["models"].values():
        assert _key_tree(doc["models"]["MARN1_onlysp"]) == _key_tree(model)
    runs = [json.loads(line) for line in lines if line.startswith('{"model"')]
    assert [(r["dtype"], r["seed"]) for r in runs] == [("f32", 111), ("bf16", 111)]
    for r, dtype in zip(runs, ("f32", "bf16")):
        got = doc["models"]["MARN1_onlysp"][dtype]["runs"][0]
        assert got == {k: v for k, v in r.items() if k not in ("model", "dtype", "seed")}
        assert np.isfinite([got["final_loss"], got["f1"]]).all() and 0 <= got["f1"] <= 100
    assert summary == {"summary": {"MARN1_onlysp": doc["models"]["MARN1_onlysp"][
        "within_seed_noise"]}}


@pytest.fixture(scope="module")
def jax_artifacts(tmp_path_factory):
    """onlysp's seeded weights, in the JAX tree, as three ``SER2`` v3 files."""
    tree = {}
    for name, v in to_jax_params(Predictor(seed=0, device="cpu").model.state_dict()).items():
        *heads, leaf = name.split("/")
        node = tree
        for head in heads:
            node = node.setdefault(head, {})
        node[leaf] = v
    out = tmp_path_factory.mktemp("artifacts")
    paths = [str(out / f"onlysp_{d}.ser") for d in ("f32", "bf16", "int8")]
    for path, dtype in zip(paths, ("f32", "bf16", "int8")):
        jsave_model(path, "MARN1_onlysp", tree, L, B, platforms=("cpu",), dtype=dtype)
    return paths


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_compare_artifacts", ROOT / "scripts" / "compare_artifacts.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class _PortServing:
    """``ser_tpu.serving.ServingModel``'s ``load`` as the port's, on the CPU."""

    @staticmethod
    def load(path):
        return ServingModel.load(path, device="cpu")


def test_compare_artifacts_is_the_jax_script(jax_artifacts, monkeypatch):
    script = _jax_script()
    jax_report, _ = _run(script.main, jax_artifacts)
    ours, lines = _run(compare_artifacts.main, [*jax_artifacts, "--device", "cpu"])
    monkeypatch.setattr(jserving, "ServingModel", _PortServing)
    theirs, jax_lines = _run(script.main, jax_artifacts)
    assert ours.keys() == jax_report.keys() == theirs.keys()
    for key in ("model", "shape", "baseline"):
        assert ours[key] == jax_report[key] == theirs[key]
    assert ours["shape"] == [L, B] and ours["baseline"]["dtype"] == "f32"
    for dtype in ("bf16", "int8"):
        assert ours[dtype].keys() == jax_report[dtype].keys()
        assert ours[dtype]["path"] == theirs[dtype]["path"]
        for fig in ("max_logp_drift", "mean_logp_drift"):
            assert abs(ours[dtype][fig] - theirs[dtype][fig]) <= 1e-4, (dtype, fig)
            assert ours[dtype][fig] > 0
        assert ours[dtype]["argmax_agreement"] == theirs[dtype]["argmax_agreement"]
    assert len(lines) == len(jax_lines) == 3


def test_compare_artifacts_refuses_another_model(jax_artifacts, tmp_path):
    other = str(tmp_path / "bilstm.ser")
    save_model(other, "BiLSTM", Predictor("BiLSTM", seed=0, device="cpu").model.state_dict(),
               L, B)
    with pytest.raises(ValueError, match="holds BiLSTM, not MARN1_onlysp"):
        compare_artifacts.main([jax_artifacts[0], other, "--device", "cpu"])


@pytest.mark.parametrize("script", [convergence_bf16, compare_artifacts])
def test_scripts_run_on_cuda_by_default(script, jax_artifacts, monkeypatch):
    """Without ``--device`` a script runs on ``cuda``; where CUDA is missing
    it raises before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(convergence_bf16, "generate_iemocap_pickles", None)
    argv = jax_artifacts if script is compare_artifacts else ["--epochs", "1"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        script.main(argv)
