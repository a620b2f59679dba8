"""The port's analysis surface against the JAX package, on the CPU.

- ``train.metrics.topk_accuracy`` against the JAX function;
- ``utils.confusion``: ``confusion_matrix`` and ``cm_analysis``'s percent
  matrix against the JAX functions, the plot files written;
- ``python -m ser_tpu_torch.analysis`` against the JAX ``analysis.py`` on one
  ``res.csv`` in the predict CLI's columns and one ``parameters.csv`` in the
  train CLI's, both made from a seed with numpy: the same JSON report, plot
  paths included; ``analyze_res`` without an output directory imports
  neither pandas nor matplotlib;
- ``IEMOCAPRobertaCometDataset`` against the JAX class on the pickles of
  ``tests/test_meld.py::test_comet_dataset``: every item of every split;
- ``compat.torch_import`` against the JAX package's on one reference-format
  file (``module.model.`` keys, one key missing, one extra): the same log
  lines and the same parameters;
- ``utils.flops.count_flops``: a ``Linear`` and a ``bmm`` count ``2·M·N·K``,
  as ``ser_tpu.utils.flops.jit_flops`` does on the same functions; onlysp's
  eval forward at a small size is printed beside XLA's count (not held
  equal: the counter counts products only, on every step of the loop; XLA
  counts elementwise work too, and a scan's body once whatever its
  length).
"""

import json
import os
import pickle
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ser_tpu.data.datasets import IEMOCAPRobertaCometDataset as JComet
from ser_tpu.train.metrics import topk_accuracy as jtopk_accuracy
from ser_tpu.utils import confusion as jconfusion
from ser_tpu.utils.flops import jit_flops
from ser_tpu_torch.data.datasets import IEMOCAPRobertaCometDataset
from ser_tpu_torch.predict import write_res_csv
from ser_tpu_torch.train.__main__ import write_parameters_csv
from ser_tpu_torch.train.metrics import topk_accuracy
from ser_tpu_torch.utils import confusion
from ser_tpu_torch.utils.flops import H100_SXM_F32_PEAK_TFLOPS, count_flops, efficiency

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("topk", [(1,), (1, 3), (2, 5)])
def test_topk_accuracy_matches_jax(topk):
    rng = np.random.default_rng(0)
    output = rng.standard_normal((50, 6)).astype(np.float32)
    output[:5] = 0.0  # ties
    target = rng.integers(0, 6, 50)
    assert topk_accuracy(output, target, topk) == jtopk_accuracy(output, target, topk)


def test_confusion_matrix_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    y_true, y_pred = rng.integers(0, 7, 200), rng.integers(0, 7, 200)  # 6: outside
    labels = list(range(6))
    cm = confusion.confusion_matrix(y_true, y_pred, labels)
    np.testing.assert_array_equal(cm, jconfusion.confusion_matrix(y_true, y_pred, labels))
    inside = (y_true < 6) & (y_pred < 6)
    assert cm.sum() == inside.sum() and cm[2, 3] == ((y_true == 2) & (y_pred == 3)).sum()
    names = ["hap", "sad", "neu", "ang", "exc", "fru"]
    ymap = dict(enumerate(names))
    t, p = y_true[inside], y_pred[inside]
    perc = confusion.cm_analysis(t, p, str(tmp_path / "port"), labels, ymap=ymap)
    want = jconfusion.cm_analysis(t, p, str(tmp_path / "jax"), labels, ymap=ymap)
    np.testing.assert_array_equal(perc, want)
    assert (tmp_path / "port.png").exists() and (tmp_path / "port.pdf").exists()


@pytest.fixture(scope="module")
def eval_dump(tmp_path_factory):
    """A ``res.csv`` as the predict CLI writes it (bucketed padding rows
    with mask 0) and a ``parameters.csv`` as the train CLI writes it."""
    out = tmp_path_factory.mktemp("analysis")
    rng = np.random.default_rng(2)
    n = 400
    labels = rng.integers(0, 6, n)
    preds = np.where(rng.random(n) < 0.6, labels, rng.integers(0, 6, n))
    masks = (rng.random(n) < 0.85).astype(np.float32)
    write_res_csv(out / "res.csv", preds, labels, masks)
    write_parameters_csv(out / "parameters.csv", {
        "w": rng.random(5).tolist(), "v": rng.random(5).tolist()})
    return out


def test_analysis_cli_report_matches_jax(eval_dump):
    flags = ["--res", str(eval_dump / "res.csv"), "--parameters",
             str(eval_dump / "parameters.csv"), "--out", str(eval_dump / "plots")]
    reports = []
    for cmd in ([sys.executable, "-m", "ser_tpu_torch.analysis"],
                [sys.executable, os.path.join(ROOT, "analysis.py")]):
        run = subprocess.run(cmd + flags, cwd=ROOT, capture_output=True, text=True,
                             env={**os.environ, "JAX_PLATFORMS": "cpu"}, timeout=300)
        assert run.returncode == 0, run.stderr[-2000:]
        reports.append(json.loads(run.stdout))
    assert reports[0] == reports[1]
    rep = reports[0]
    assert rep["n_rows"] == 400 and 0 < rep["n_valid"] < 400
    assert sorted(rep["per_class_accuracy"]) == [str(c) for c in range(6)]
    assert os.path.exists(rep["confusion_plot"]) and os.path.exists(rep["fusion_weights_plot"])


def test_analyze_res_without_plots_needs_no_matplotlib_or_pandas(eval_dump):
    code = ("import json, sys; from ser_tpu_torch.analysis import analyze_res; "
            f"r = analyze_res({str(eval_dump / 'res.csv')!r}); "
            "assert 'confusion_plot' not in r; "
            "assert not {'matplotlib', 'pandas'} & set(sys.modules), sorted(sys.modules); "
            "print(json.dumps(r))")
    run = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert run.returncode == 0, run.stderr[-2000:]
    rep = json.loads(run.stdout)
    from analysis import analyze_res as janalyze_res  # the JAX package's CLI module

    assert json.loads(json.dumps(janalyze_res(str(eval_dump / "res.csv")))) == rep


def _comet_pickles(tmp_path):
    """``tests/test_meld.py::test_comet_dataset``'s two pickles."""
    rng = np.random.default_rng(0)
    vids = ["d0", "d1", "d2"]
    lens = {v: int(rng.integers(3, 6)) for v in vids}
    rob = lambda: {v: rng.standard_normal((lens[v], 1024)).astype(np.float32)  # noqa: E731
                   for v in vids}
    speakers = {v: ["M" if s else "F" for s in rng.integers(0, 2, lens[v])] for v in vids}
    labels = {v: rng.integers(0, 6, lens[v]).tolist() for v in vids}
    sentences = {v: ["s"] * lens[v] for v in vids}
    roberta_path = str(tmp_path / "roberta.pkl")
    with open(roberta_path, "wb") as f:
        pickle.dump((speakers, labels, rob(), rob(), rob(), rob(), sentences, vids[:2],
                     vids[2:], vids[2:]), f)
    comet_path = str(tmp_path / "comet.pkl")
    comet = tuple({v: rng.standard_normal((lens[v], 768)).astype(np.float32) for v in vids}
                  for _ in range(9))
    with open(comet_path, "wb") as f:
        pickle.dump(comet, f)
    return roberta_path, comet_path


def test_comet_dataset_matches_jax(tmp_path):
    paths = _comet_pickles(tmp_path)
    for split, n in (("train", 2), ("test", 1), ("valid", 1)):
        ds, jds = IEMOCAPRobertaCometDataset(split, *paths), JComet(split, *paths)
        assert len(ds) == len(jds) == n
        for i in range(n):
            got, want = ds[i], jds[i]
            assert len(got) == len(want) == 17
            assert got[-1] == want[-1]
            for a, b in zip(got[:-1], want[:-1]):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    assert ds[0][4].shape[-1] == 768 and ds[0][13].shape[-1] == 2  # xIntent, qmask
    for cls in (IEMOCAPRobertaCometDataset, JComet):
        with pytest.raises(ValueError, match="unknown split: dev"):
            cls("dev", *paths)


def test_torch_import_matches_jax(tmp_path):
    """A reference-format file of BiLSTM (``torch.save`` of the trainer's
    state dict under ``module.model.``) with one key gone and one key the
    model lacks: the port's import and the JAX package's print the same
    lines and load the same values."""
    from ser_tpu.compat.torch_import import import_torch_checkpoint as jimport
    from ser_tpu_torch.compat import import_torch_checkpoint
    from ser_tpu_torch.compat.from_jax import to_jax_params
    from ser_tpu_torch.models.registry import build_model
    from ser_tpu_torch.ops.init import generator

    source = build_model("BiLSTM", generator(7)).state_dict()
    sd = {f"module.model.{k}": v for k, v in source.items() if k != "nn_out.3.weight"}
    sd["module.model.extra.weight"] = torch.ones(3)
    path = tmp_path / "model_0001.model"
    torch.save(sd, path)

    model = build_model("BiLSTM", generator(0))
    start = to_jax_params(model.state_dict())
    lines, jlines = [], []
    loaded = import_torch_checkpoint(model, path, "BiLSTM", log=lines.append)
    template = {}
    for name, v in start.items():  # the JAX tree of the same starting values
        node = template
        *heads, leaf = name.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[leaf] = jnp.asarray(v)
    jparams = jimport(template, path, "BiLSTM", log=jlines.append)
    assert sorted(lines) == sorted(jlines) == ["extra.weight is not in the model.",
                                               "nn_out.3.weight is not in the checkpoint."]
    assert len(loaded) == len(source) - 1
    got = to_jax_params(model.state_dict())
    from ser_tpu.train.checkpoint import flatten_params

    want = flatten_params(jparams)
    assert sorted(got) == sorted(want)
    for name, v in got.items():
        np.testing.assert_array_equal(v, np.asarray(want[name]), err_msg=name)
    np.testing.assert_array_equal(got["nn_out_3/kernel"], start["nn_out_3/kernel"])  # kept


@pytest.mark.parametrize("M, K, N", [(4, 8, 16), (31, 100, 6)])
def test_count_flops_of_products_is_2mnk_as_xla_counts(M, K, N):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = rng.standard_normal((N, K)).astype(np.float32)
    lin = torch.nn.Linear(K, N, bias=False)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w))
    assert count_flops(lin, torch.from_numpy(x)) == 2 * M * N * K
    assert jit_flops(lambda a, b: a @ b.T, jnp.asarray(x), jnp.asarray(w)) == 2 * M * N * K
    a = rng.standard_normal((3, M, K)).astype(np.float32)
    b = rng.standard_normal((3, K, N)).astype(np.float32)
    assert count_flops(torch.bmm, torch.from_numpy(a), torch.from_numpy(b)) == 2 * 3 * M * N * K
    assert jit_flops(jnp.matmul, jnp.asarray(a), jnp.asarray(b)) == 2 * 3 * M * N * K


def test_count_flops_of_onlysp_eval_beside_xla():
    """Printed, not held equal (the module docstring)."""
    import jax

    from ser_tpu.models.registry import get_model_spec as jget_model_spec
    from ser_tpu.train.checkpoint import flatten_params
    from ser_tpu_torch.compat.from_jax import from_jax_params
    from ser_tpu_torch.data.synthetic import synthetic_batch
    from ser_tpu_torch.models.registry import get_model_spec
    from ser_tpu_torch.serving import Predictor

    batch = synthetic_batch(L=8, B=2, seed=0, min_len=4)
    x, qmask, umask = get_model_spec("MARN1_onlysp").make_inputs(batch)
    jspec = jget_model_spec("MARN1_onlysp")
    jmodel = jspec.build(6, "IEMOCAP")
    args = tuple(map(jnp.asarray, (x, qmask, umask)))
    key = jax.random.PRNGKey(0)
    params = jmodel.init({"params": key, "dropout": key}, *args, deterministic=True)["params"]
    xla = jit_flops(lambda p, *a: jmodel.apply({"params": p}, *a, deterministic=True),
                    params, *args)
    pred = Predictor("MARN1_onlysp", state_dict=from_jax_params(flatten_params(params)),
                     device="cpu")
    ins = tuple(torch.as_tensor(a) for a in (x, qmask, umask))
    with torch.inference_mode():
        port = count_flops(pred.model, *ins)
    print(f"onlysp eval [8, 2]: count_flops {port}, XLA cost analysis {xla}")
    assert port > 0 and xla > 0
    eff = efficiency(port, 1e-3)
    assert eff["flops_per_pass"] == port
    assert eff["pct_f32_peak"] == round(100 * port / 1e-3 / 1e12 / H100_SXM_F32_PEAK_TFLOPS, 2)
    with pytest.raises(ValueError, match="CPU tensors"):
        _cuda_refusal(ins)


def _cuda_refusal(ins):
    """``count_flops`` refuses a CUDA tensor; without a card, a stand-in
    whose ``is_cuda`` is true."""
    class Cuda(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    count_flops(lambda *a: None, ins[0].as_subclass(Cuda))
