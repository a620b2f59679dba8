"""The port's serving artifacts (``ser_tpu_torch.serving``) and ``python -m
ser_tpu_torch.serve export|run|bench`` on the CPU, against the JAX
package's ``ser_tpu/serving.py`` and ``serve.py``.

Weights come from a JAX init through ``compat.from_jax.from_jax_params``, at
L = 12, B = 4. Pinned here:

- the port's counterparts of the JAX contracts of ``tests/test_serving.py``
  and ``tests/test_serving_int8.py``: the round trip, the padding contract,
  oversize batches, bucket selection and ``last_bucket``, the header's
  largest shape, the CLI's export then run, its bench, bf16's drift, a bad
  dtype, int8's reconstruction bound, int8 against f32 and its size;
- the port's weights section and ``params.leaves`` equal to the JAX
  artifact's byte for byte (onlysp in f32 and bf16, newz in int8), and its
  dequantized int8 weights equal to the JAX ``_dequantize_int8(...,
  bfloat16)`` bit for bit;
- a JAX ``SER2`` v3 artifact served by the port as by the JAX
  ``ServingModel`` (onlysp; MARN_ATV, trimodal and time-major) to atol 3e-4
  + rtol 1e-3; the JAX loader refusing a ``SERT`` file; the port refusing
  ``SER1`` and ``SER2`` v2 files;
- ``serve run`` equal to the JAX ``serve.py run`` on one checkpoint and one
  set of pickles (BiLSTM; onlysp, also read as a reference torch state
  dict with ``module.model.`` keys); a MELD artifact through ``run``;
- every registry model's f32 artifact equal bit for bit to the port's eager
  ``Predictor`` on the padded batch, and its bf16 and int8 artifacts finite;
- the torch-format checkpoint load stripping ``module.`` and then
  ``model.`` as the JAX ``strip_prefixes`` does, printing the keys it
  lacks and the keys it did not use.
One intra-op thread, as the other CLI test files.
"""

import json
import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import serve as jserve
from ser_tpu.compat.torch_import import strip_prefixes
from ser_tpu.data.synthetic import generate_iemocap_pickles as jgenerate
from ser_tpu.data.synthetic import synthetic_batch
from ser_tpu.models.registry import get_model_spec as jget_model_spec
from ser_tpu.serving import ServingModel as JServingModel
from ser_tpu.serving import _dequantize_int8 as jdequantize_int8
from ser_tpu.serving import _quantize_int8 as jquantize_int8
from ser_tpu.serving import save_model as jsave_model
from ser_tpu.train.checkpoint import flatten_params, save_parameters
from ser_tpu_torch import serve as tserve
from ser_tpu_torch.compat.from_jax import from_jax_params
from ser_tpu_torch.data.synthetic import generate_meld_pickles
from ser_tpu_torch.models.registry import available_models
from ser_tpu_torch.serving import (Predictor, ServingModel, _dequantize_int8, _quantize_int8,
                                   save_model)
from ser_tpu_torch.train.checkpoint import load_parameters

L, B = 12, 4
SMALL = dict(n_train=10, n_test=6, min_len=4, max_len=12)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_params(name, seed=0):
    spec = jget_model_spec(name)
    batch = {k: jnp.asarray(v) for k, v in
             synthetic_batch(L=L, B=B, seed=0).items() if k != "vid"}
    key = jax.random.PRNGKey(seed)
    return spec.build(6, "IEMOCAP").init({"params": key, "dropout": key},
                                         *spec.make_inputs(batch), deterministic=True)["params"]


@pytest.fixture(scope="module")
def params():
    """JAX-initialised parameters of onlysp, newz and MARN_ATV."""
    return {name: _jax_params(name) for name in ("MARN1_onlysp", "MARN1_newz", "MARN_ATV")}


def _state(params):
    return from_jax_params(flatten_params(params))


def _batch(l, b, seed):
    return {k: v for k, v in synthetic_batch(L=l, B=b, seed=seed).items() if k != "vid"}


def _jax_forward(name, params, batch):
    """The JAX model on ``batch``, ``[B, L, C]`` batch-major."""
    spec = jget_model_spec(name)
    args = spec.make_inputs({k: jnp.asarray(v) for k, v in batch.items()})
    out = np.asarray(spec.extract_logp(spec.build(6, "IEMOCAP").apply(
        {"params": params}, *args, deterministic=True)))
    b, l = np.shape(batch["umask"])
    return out.reshape(b, l, -1)


def _pad(batch, Lp, Bp):
    b, l = np.shape(batch["umask"])
    return {k: np.pad(np.asarray(v), [(0, Bp - b), (0, Lp - l)] if k in ("umask", "label")
                      else [(0, Lp - l), (0, Bp - b)] + [(0, 0)] * (np.ndim(v) - 2))
            for k, v in batch.items()}


def _save(tmp_path, name, state, Ls=L, Bs=B, **kwargs):
    path = str(tmp_path / f"{name}_{kwargs.get('dtype', 'f32')}.ser")
    save_model(path, name, state, Ls, Bs, **kwargs)
    return path


@pytest.fixture(scope="module")
def jax_onlysp(params, tmp_path_factory):
    """A JAX ``SER2`` v3 artifact of onlysp at buckets [12, 2] and [12, 4]."""
    path = str(tmp_path_factory.mktemp("jax") / "onlysp.ser")
    jsave_model(path, "MARN1_onlysp", params["MARN1_onlysp"], L, [2, B], platforms=("cpu",))
    return path


def _sections(path):
    """``(header, weights section bytes)`` of an artifact of either package."""
    with open(path, "rb") as f:
        data = f.read()
    (hlen,) = struct.unpack("<I", data[4:8])
    header = json.loads(data[8:8 + hlen])
    (plen,) = struct.unpack("<Q", data[8 + hlen:16 + hlen])
    return header, data[16 + hlen:16 + hlen + plen]


def test_roundtrip_exact_at_export_shape(params, tmp_path):
    p = params["MARN1_onlysp"]
    served = ServingModel.load(_save(tmp_path, "MARN1_onlysp", _state(p)), device="cpu")
    batch = _batch(L, B, 3)
    out = served.predict(batch)
    assert out["logp"].shape == (B, L, 6) and out["logp"].dtype == np.float32
    np.testing.assert_allclose(out["logp"], _jax_forward("MARN1_onlysp", p, batch),
                               rtol=1e-3, atol=2e-4)
    np.testing.assert_array_equal(out["preds"], out["logp"].argmax(-1))


def test_padding_contract_smaller_batch(params, tmp_path):
    """A [l < L, b < B] batch equals the model on the same batch padded to
    [L, B]: the port's eager forward bit for bit, the JAX model to rtol 1e-3."""
    p = params["MARN1_onlysp"]
    state = _state(p)
    served = ServingModel.load(_save(tmp_path, "MARN1_onlysp", state), device="cpu")
    small = _batch(8, 2, 5)
    out = served.predict(small)
    assert out["logp"].shape == (2, 8, 6) and out["preds"].shape == (2, 8)
    padded = _pad(small, L, B)
    inputs = served.padded_inputs(small, (L, B))
    for a, b in zip(inputs, served._make_inputs(padded)):
        np.testing.assert_array_equal(a, b)
    eager = Predictor("MARN1_onlysp", state_dict=state, device="cpu").predict(
        *inputs)[0].numpy().reshape(B, L, 6)[:2, :8]
    np.testing.assert_array_equal(out["logp"], eager)
    np.testing.assert_allclose(out["logp"], _jax_forward("MARN1_onlysp", p, padded)[:2, :8],
                               rtol=1e-3, atol=2e-4)


def test_oversize_batch_rejected(params, tmp_path):
    served = ServingModel.load(_save(tmp_path, "MARN1_onlysp", _state(params["MARN1_onlysp"])),
                               device="cpu")
    with pytest.raises(ValueError, match=rf"batch \[{L + 4}, {B}\] exceeds the exported "
                                         rf"shape \[{L}, {B}\]"):
        served.predict(_batch(L + 4, B, 1))


def test_bucketed_export_selects_smallest_admitting(params, tmp_path):
    """Each query goes to the smallest admitting bucket, and every bucket
    agrees with the model on the batch padded to it."""
    p = params["MARN1_onlysp"]
    served = ServingModel.load(_save(tmp_path, "MARN1_onlysp", _state(p), Bs=[B, 2]),
                               device="cpu")
    assert served.buckets == [(L, 2), (L, B)]
    small = _batch(8, 1, 4)
    out = served.predict(small)
    assert served.last_bucket == (L, 2)
    np.testing.assert_allclose(out["logp"], _jax_forward(
        "MARN1_onlysp", p, _pad(small, L, 2))[:1, :8], rtol=1e-3, atol=2e-4)
    big = _batch(L, 3, 6)
    out = served.predict(big)
    assert served.last_bucket == (L, B)  # b = 3 overflows the B = 2 bucket
    np.testing.assert_allclose(out["logp"], _jax_forward(
        "MARN1_onlysp", p, _pad(big, L, B))[:3], rtol=1e-3, atol=2e-4)


def test_bucketed_oversize_rejected_and_header_max(params, tmp_path):
    served = ServingModel.load(_save(tmp_path, "MARN1_onlysp", _state(params["MARN1_onlysp"]),
                                     Bs=[2, B]), device="cpu")
    assert (served.header["L"], served.header["B"]) == (L, B)
    with pytest.raises(ValueError, match="exceeds the exported shape"):
        served.predict(_batch(L, B + 1, 1))


def test_header_has_the_jax_keys_and_conventions(params, jax_onlysp, tmp_path):
    """The port's header: the JAX header's keys and values but for the
    platforms; the inputs convention and row layout of a trimodal
    time-major model."""
    ours = _sections(_save(tmp_path, "MARN1_onlysp", _state(params["MARN1_onlysp"]),
                           Bs=[2, B]))[0]
    theirs = _sections(jax_onlysp)[0]
    assert list(ours) == list(theirs)
    assert ours.pop("platforms") == ["cuda", "cpu"] and theirs.pop("platforms") == ["cpu"]
    assert ours == theirs
    atv = ServingModel.load(_save(tmp_path, "MARN_ATV", _state(params["MARN_ATV"])),
                            device="cpu")
    assert (atv.header["inputs"], atv.header["logp_layout"]) == ("trimodal", "tb")
    assert (ours["inputs"], ours["logp_layout"]) == ("marn1", "bl")


@pytest.mark.parametrize("name,dtype", [("MARN1_onlysp", "f32"), ("MARN1_onlysp", "bf16"),
                                        ("MARN1_newz", "int8")])
def test_weights_section_equals_jax_byte_for_byte(name, dtype, params, jax_onlysp, tmp_path):
    ours = _sections(_save(tmp_path, name, _state(params[name]), dtype=dtype))
    if (name, dtype) == ("MARN1_onlysp", "f32"):
        path = jax_onlysp
    else:
        path = str(tmp_path / "jax.ser")
        jsave_model(path, name, params[name], L, B, platforms=("cpu",), dtype=dtype)
    theirs = _sections(path)
    assert ours[0]["params"] == theirs[0]["params"]
    assert ours[1] == theirs[1]
    assert ours[0]["dtype"] == dtype


def test_dequantized_int8_equals_jax_bit_for_bit(params):
    """The port's ``q.bf16 * s.bf16`` at load and the JAX package's per-call
    ``_dequantize_int8(..., bfloat16)``: the same bf16 values."""
    p = jax.tree_util.tree_map(np.asarray, params["MARN1_newz"])
    theirs = flatten_params(jdequantize_int8(
        jax.tree_util.tree_map(jnp.asarray, jquantize_int8(p)), jnp.bfloat16))
    ours = _dequantize_int8({k: torch.tensor(v) for k, v in
                             _quantize_int8(flatten_params(p)).items()})
    assert sorted(ours) == sorted(theirs)
    for name, t in ours.items():
        assert t.dtype == torch.bfloat16, name
        want = np.asarray(theirs[name]).view(np.uint16)
        np.testing.assert_array_equal(t.view(torch.int16).numpy().view(np.uint16), want,
                                      err_msg=name)


def test_quantize_reconstruction_bound(params):
    flat = flatten_params(jax.tree_util.tree_map(np.asarray, params["MARN1_newz"]))
    q = _quantize_int8(flat)
    for name, orig in flat.items():
        if orig.ndim < 2:
            np.testing.assert_array_equal(q[name], orig)
            continue
        assert q[f"{name}/q"].dtype == np.int8 and q[f"{name}/s"].dtype == np.float32
        rec = q[f"{name}/q"].astype(np.float32) * q[f"{name}/s"]
        step = np.max(np.abs(orig), axis=tuple(range(orig.ndim - 1)), keepdims=True) / 127.0
        assert np.all(np.abs(orig - rec) <= 0.51 * step + 1e-9), name


def test_int8_artifact_close_to_f32(params, tmp_path):
    state = _state(params["MARN1_newz"])
    p32 = _save(tmp_path, "MARN1_newz", state)
    p8 = _save(tmp_path, "MARN1_newz", state, dtype="int8")
    assert os.path.getsize(p8) < 0.45 * os.path.getsize(p32)
    batch = _batch(L, B, 3)
    out32 = ServingModel.load(p32, device="cpu").predict(batch)
    out8 = ServingModel.load(p8, device="cpu").predict(batch)
    valid = np.asarray(batch["umask"]) > 0
    agree = (out8["preds"] == out32["preds"])[valid].mean()
    drift = np.abs(out8["logp"] - out32["logp"])[valid].max()
    assert agree >= 0.9, f"argmax agreement {agree}"
    assert np.isfinite(drift) and drift < 1.0, drift


def test_bf16_export_deployment_precision(params, tmp_path):
    """bf16 weights and a bf16-autocast forward, f32 in and out: the
    log-probs within the JAX package's bf16 drift bounds of the f32
    artifact's."""
    state = _state(params["MARN1_onlysp"])
    s32 = ServingModel.load(_save(tmp_path, "MARN1_onlysp", state), device="cpu")
    s16 = ServingModel.load(_save(tmp_path, "MARN1_onlysp", state, dtype="bf16"), device="cpu")
    assert s16.header["dtype"] == "bf16"
    batch = _batch(L, B, 5)
    o32, o16 = s32.predict(batch), s16.predict(batch)
    assert o16["logp"].dtype == np.float32 and np.all(np.isfinite(o16["logp"]))
    assert not np.array_equal(o16["logp"], o32["logp"])
    err = np.abs(o16["logp"] - o32["logp"])
    assert err.max() < 0.5 and err.mean() < 0.1, (err.max(), err.mean())
    # the weights the bf16 model holds are bf16 values
    w = s16.model.state_dict()["nn_out.0.weight"]
    assert torch.equal(w, w.to(torch.bfloat16).float())


def test_bf16_export_rejects_bad_dtype(params, tmp_path):
    with pytest.raises(ValueError, match="dtype"):
        _save(tmp_path, "MARN1_onlysp", _state(params["MARN1_onlysp"]), dtype="fp8")


@pytest.mark.parametrize("name", ["MARN1_onlysp", "MARN_ATV"])
def test_port_serves_a_jax_ser2_artifact(name, params, jax_onlysp, tmp_path):
    if name == "MARN1_onlysp":
        path, batches = jax_onlysp, [_batch(8, 1, 4), _batch(L, 3, 6)]
    else:
        path, batches = str(tmp_path / "atv.ser"), [_batch(10, 3, 2)]
        jsave_model(path, name, params[name], L, B, platforms=("cpu",))
    ours, theirs = ServingModel.load(path, device="cpu"), JServingModel.load(path)
    assert ours.buckets == theirs.buckets
    for batch in batches:
        got, want = ours.predict(batch), theirs.predict(batch)
        assert ours.last_bucket == theirs.last_bucket
        assert got["logp"].shape == want["logp"].shape
        np.testing.assert_allclose(got["logp"], want["logp"], rtol=1e-3, atol=3e-4)


def test_jax_loader_refuses_a_sert_artifact(params, tmp_path):
    path = _save(tmp_path, "MARN1_onlysp", _state(params["MARN1_onlysp"]))
    with pytest.raises(ValueError, match="not a ser_tpu serving artifact"):
        JServingModel.load(path)


def test_port_refuses_programs_with_baked_weights(tmp_path):
    header = json.dumps({"model": "MARN1_onlysp", "L": L, "B": B, "buckets": [[L, B]]}).encode()
    for magic in (b"SER1", b"SER2"):
        path = tmp_path / f"{magic.decode()}.ser"
        path.write_bytes(magic + struct.pack("<I", len(header)) + header + b"\0" * 16)
        with pytest.raises(ValueError, match="baked into a StableHLO program"):
            ServingModel.load(str(path), device="cpu")
    other = tmp_path / "other.ser"
    other.write_bytes(b"PK\3\4" + b"\0" * 16)
    with pytest.raises(ValueError, match="not a ser_tpu serving artifact"):
        ServingModel.load(str(other), device="cpu")


def _last_json(out: str) -> dict:
    """The last indented JSON object ``out`` printed."""
    lines = out.splitlines()
    start = len(lines) - 1 - lines[::-1].index("{")
    return json.loads("\n".join(lines[start:]))


@pytest.mark.parametrize("name", ["BiLSTM", "MARN1_onlysp"])
def test_serve_cli_export_then_run_matches_jax(name, tmp_path, capsys):
    """One checkpoint and one set of pickles: the JAX ``serve.py export``
    then ``run``, and the port's, give the same metrics JSON; onlysp's
    checkpoint also as a reference torch state dict with ``module.model.``
    keys (``--torch_format``)."""
    params = _jax_params(name, seed=7)
    ckpt = str(tmp_path / "model.npz")
    save_parameters(params, ckpt)
    feats = jgenerate(str(tmp_path / "data"), seed=1, **SMALL)
    flags = ["--model", name, "--L", "16", "--B", "8"]
    jserve.main(["export", "--initial_model", ckpt, "--out", str(tmp_path / "jax.ser"),
                 "--platforms", "cpu", *flags])
    jserve.main(["run", "--artifact", str(tmp_path / "jax.ser"), "--feature_path", feats])
    theirs = _last_json(capsys.readouterr().out)
    runs = [["--initial_model", ckpt]]
    if name == "MARN1_onlysp":
        ref = str(tmp_path / "reference.model")
        torch.save({f"module.model.{k}": v for k, v in _state(params).items()}, ref)
        runs.append(["--initial_model", ref, "--torch_format"])
    for i, src in enumerate(runs):
        art = str(tmp_path / f"torch{i}.ser")
        tserve.main(["export", "--out", art, *flags, *src])
        out = capsys.readouterr().out
        assert "is not in" not in out
        assert json.loads(out.strip().splitlines()[-1]) == {
            "artifact": art, "model": name, "buckets": [[16, 8]], "platforms": "cuda,cpu",
            "dtype": "f32"}
        tserve.main(["run", "--artifact", art, "--feature_path", feats, "--device", "cpu"])
        ours = _last_json(capsys.readouterr().out)
        assert ours.pop("artifact") == art
        assert ours == {k: v for k, v in theirs.items() if k != "artifact"}


def test_serve_cli_bench_smoke(params, tmp_path, capsys):
    ckpt = str(tmp_path / "bilstm.npz")
    save_parameters(_jax_params("BiLSTM", seed=3), ckpt)
    art = str(tmp_path / "bilstm.ser")
    tserve.main(["export", "--initial_model", ckpt, "--model", "BiLSTM", "--out", art,
                 "--L", "12", "--B", "2,4"])
    capsys.readouterr()
    tserve.main(["bench", "--artifact", art, "--iters", "3", "--device", "cpu"])
    report = _last_json(capsys.readouterr().out)
    assert report["backend"] == "cpu" and report["model"] == "BiLSTM"
    assert set(report["buckets"]) == {"L12_B2", "L12_B4"}
    for row in report["buckets"].values():
        assert row["ms_per_call"] > 0 and np.isfinite(row["utterances_per_sec"])


def test_serve_cli_meld_and_refusals(tmp_path, capsys):
    """A 7-class MELD artifact (nine parties) through export and run; an
    export under a zoo encoder attention records its kind, an unknown kind
    is refused; the artifact's commands need CUDA unless given the CPU."""
    model = Predictor("MARN1_onlysp", seed=2, device="cpu", n_classes=7).model
    ckpt = str(tmp_path / "meld.npz")
    from ser_tpu_torch.train.checkpoint import save_parameters as tsave_parameters
    tsave_parameters(model, ckpt)
    feats = generate_meld_pickles(str(tmp_path / "meld"), n_train=6, n_test=5, min_len=4,
                                  max_len=12, seed=4)
    art = str(tmp_path / "meld.ser")
    tserve.main(["export", "--initial_model", ckpt, "--out", art, "--dataset", "MELD",
                 "--n_classes", "7", "--L", "16", "--B", "2,8"])
    tserve.main(["run", "--artifact", art, "--feature_path", feats, "--device", "cpu"])
    report = _last_json(capsys.readouterr().out)
    assert report["model"] == "MARN1_onlysp" and report["n_utterances"] > 0
    assert 0 <= report["weighted_accuracy"] <= 100
    zoo = str(tmp_path / "zoo.ser")
    tserve.main(["export", "--initial_model", ckpt, "--out", zoo, "--dataset", "MELD",
                 "--n_classes", "7", "--L", "16", "--B", "2", "--encoder_attention",
                 "external"])
    assert ServingModel.load(zoo, device="cpu").header["encoder_attention"] == "external"
    with pytest.raises(ValueError, match="unknown encoder attention 'mhb'"):
        tserve.main(["export", "--initial_model", ckpt, "--out", art,
                     "--encoder_attention", "mhb"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tserve.main(["bench", "--artifact", art])


@pytest.mark.parametrize("name", available_models())
def test_every_model_f32_artifact_equals_eager_predictor(name, tmp_path):
    """The f32 artifact on a [10, 3] batch in its [12, 4] bucket: the port's
    eager ``Predictor`` on the padded batch, bit for bit; the bf16 and int8
    artifacts of the same weights finite, of the same shape."""
    state = Predictor(name, seed=5, device="cpu").model.state_dict()
    batch = _batch(10, 3, 8)
    served = ServingModel.load(_save(tmp_path, name, state), device="cpu")
    out = served.predict(batch)
    logp = Predictor(name, state_dict=state, device="cpu").predict(
        *served._make_inputs(_pad(batch, L, B)))[0].numpy()
    C = logp.shape[-1]
    logp = (logp.reshape(L, B, C).transpose(1, 0, 2) if served.header["logp_layout"] == "tb"
            else logp.reshape(B, L, C))
    np.testing.assert_array_equal(out["logp"], logp[:3, :10])
    for dtype in ("bf16", "int8"):
        low = ServingModel.load(_save(tmp_path, name, state, dtype=dtype), device="cpu")
        got = low.predict(batch)["logp"]
        assert got.shape == out["logp"].shape and np.all(np.isfinite(got)), dtype


def test_torch_format_load_strips_module_then_model(tmp_path):
    """A ``Linear`` saved under ``module.model.`` keys loads every key, as
    the JAX package's ``strip_prefixes`` strips them; the key the file lacks
    and the key the model lacks are printed as its importer prints them."""

    class Head(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.lin = torch.nn.Linear(3, 2)
            self.scale = torch.nn.Parameter(torch.ones(2))

    saved = torch.nn.Linear(3, 2)
    sd = {f"module.model.lin.{k}": v for k, v in saved.state_dict().items()}
    sd["module.model.extra"] = torch.zeros(1)
    path = str(tmp_path / "ref.model")
    torch.save(sd, path)
    model, logs = Head(), []
    loaded = load_parameters(model, path, torch_format=True, log=logs.append)
    assert loaded == sorted(k for k in strip_prefixes(sd) if k in model.state_dict())
    assert loaded == ["lin.bias", "lin.weight"]
    assert logs == ["scale is not in the checkpoint.", "extra is not in the model."]
    for k, v in saved.state_dict().items():
        torch.testing.assert_close(model.lin.state_dict()[k], v, rtol=0, atol=0)
