"""The raw-audio serving slice as a whole, on the CPU: the port's predict CLI
against the JAX package's ``predict.py --audio_frontend mfcc``.

Both read the same small pickles (with waveforms) and the same full
MARN1_onlysp checkpoint, saved from a JAX init by the JAX package's
``save_parameters``. The JSON metrics must be equal and ``res.csv`` equal
byte for byte; ``Predictor.predict_batch`` log-probs match the JAX eval
forward with the front end at rtol 1e-3, atol 1e-4 (the port's logit
contract). One JAX compile, at L = 16.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import predict as jpredict
from ser_tpu.data.frontend import MFCCFrontend as JMFCCFrontend
from ser_tpu.data.synthetic import generate_iemocap_pickles, synthetic_batch
from ser_tpu.models.marn_onlysp import MARN1OnlySP as JMARN1OnlySP
from ser_tpu.models.registry import get_model_spec as jget_model_spec
from ser_tpu.train.checkpoint import flatten_params, save_parameters
from ser_tpu_torch import predict as tpredict
from ser_tpu_torch.compat.from_jax import from_jax_params
from ser_tpu_torch.data.loaders import get_loaders
from ser_tpu_torch.serving import Predictor
from ser_tpu_torch.train.checkpoint import load_parameters


def _last_json(out: str) -> dict:
    lines = out.splitlines()
    start = len(lines) - 1 - lines[::-1].index("{")
    return json.loads("\n".join(lines[start:]))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("predict")
    feat = generate_iemocap_pickles(str(d), n_train=5, n_test=3, min_len=4,
                                    max_len=12, seed=3, with_wav=True,
                                    wav_len=1600)
    x, qmask, umask = jget_model_spec("MARN1_onlysp").make_inputs(
        {k: jnp.asarray(v) for k, v in synthetic_batch(L=8, B=2).items()
         if k != "vid"})
    key = jax.random.PRNGKey(5)
    params = JMARN1OnlySP(n_classes=6).init(
        {"params": key, "dropout": key}, x, qmask, umask,
        deterministic=True)["params"]
    ckpt = str(d / "model.npz")
    save_parameters(params, ckpt)
    return d, feat, ckpt, params


def test_predict_cli_matches_jax(files, capsys):
    d, feat, ckpt, _ = files
    common = ["--initial_model", ckpt, "--feature_path", feat,
              "--audio_frontend", "mfcc", "--batch_size", "4"]
    jpredict.main(common + ["--res_csv", str(d / "jax.csv")])
    theirs = _last_json(capsys.readouterr().out)
    tpredict.main(common + ["--res_csv", str(d / "torch.csv"),
                            "--device", "cpu"])
    ours = _last_json(capsys.readouterr().out)
    assert ours.pop("res_csv") == str(d / "torch.csv")
    assert theirs.pop("res_csv") == str(d / "jax.csv")
    assert ours == theirs
    assert ours["n_examples"] == 3 and sorted(ours["fusion_weights"]) == [
        "v", "v1", "v2", "w"]
    assert (d / "torch.csv").read_bytes() == (d / "jax.csv").read_bytes()


def test_predict_batch_matches_jax_forward(files):
    _, feat, _, params = files
    batch = next(iter(get_loaders(feat, batch_size=4, valid=0.2,
                                  wav_path="auto")[2]))
    assert batch["wav"].shape == (16, 4, 2048)
    pred = Predictor(state_dict=from_jax_params(flatten_params(params)),
                     device="cpu", audio_frontend="mfcc")
    logp, labels = pred.predict_batch(batch)

    jb = {k: jnp.asarray(v) for k, v in batch.items() if k != "vid"}
    jb["acouf"] = JMFCCFrontend(use_pallas=False)(jb["wav"], jb["wav_len"])
    ref = np.asarray(JMARN1OnlySP(n_classes=6).apply(
        {"params": params}, *jget_model_spec("MARN1_onlysp").make_inputs(jb),
        deterministic=True)[0])
    assert torch.isfinite(logp).all()
    np.testing.assert_allclose(logp.numpy(), ref, rtol=1e-3, atol=1e-4)
    valid = batch["umask"].reshape(-1) > 0
    np.testing.assert_array_equal(labels.numpy().reshape(-1)[valid],
                                  ref.argmax(-1)[valid])


def test_predict_batch_of_features_is_predict_of_make_inputs(files):
    """Without a front end the text mean is taken on the host and joined
    with ``acouf`` on the device: the same numbers as the host-built x."""
    _, feat, _, params = files
    batch = next(iter(get_loaders(feat, batch_size=4, valid=0.2)[2]))
    assert "wav" not in batch
    pred = Predictor(state_dict=from_jax_params(flatten_params(params)),
                     device="cpu")
    logp, labels = pred.predict_batch(batch)
    want, want_labels = pred.predict(*pred.spec.make_inputs(batch))
    torch.testing.assert_close(logp, want, rtol=0, atol=0)
    torch.testing.assert_close(labels, want_labels, rtol=0, atol=0)
    assert pred.n_requests == 2


def test_cli_refuses_what_the_port_cannot_serve(files, capsys, tmp_path):
    """An unknown model or encoder attention raises; a zoo kind is served
    (the MHA checkpoint's encoder weights then have no home, and the tolerant
    loader says so)."""
    _, feat, ckpt, _ = files
    base = ["--initial_model", ckpt, "--feature_path", feat, "--device", "cpu"]
    tpredict.main(base + ["--encoder_attention", "external",
                          "--res_csv", str(tmp_path / "res.csv")])
    out = capsys.readouterr().out
    assert "is not in the model" in out
    assert np.isfinite(json.loads(out[out.index("{"):])["weighted_f1"])
    with pytest.raises(ValueError, match="unknown encoder attention 'mhb'"):
        tpredict.main(base + ["--encoder_attention", "mhb"])
    with pytest.raises(KeyError, match=r"unknown model 'MARN2'; available: .*'MARN1_onlysp'"):
        tpredict.main(base + ["--model", "MARN2"])


def test_load_parameters_is_tolerant(files, tmp_path):
    _, _, ckpt, params = files
    flat = flatten_params(params)
    flat = {("module." + k if k == "w" else k): v for k, v in flat.items()}
    flat["model/marn_cell_f/lsthm_q_W_kernel"] = np.zeros((2, 2), np.float32)
    flat["nn_out_3/bias"] = np.zeros(7, np.float32)
    path = tmp_path / "partial.npz"
    np.savez(path, **flat)
    model = Predictor(device="cpu").model
    before = model.nn_out[3].bias.detach().clone()
    logs = []
    loaded = load_parameters(model, str(path), log=logs.append)
    assert sorted(logs) == [
        "Wrong parameter length: nn_out_3/bias, model: (6,), loaded: (7,)",
        "model/marn_cell_f/lsthm_q_W_kernel is not in the model."]
    assert "w" in loaded and len(loaded) == 127
    torch.testing.assert_close(model.nn_out[3].bias, before)  # kept
    np.testing.assert_array_equal(
        model.marn_cell_b.lsthm_a.U.weight.detach().numpy(),
        np.asarray(params["marn_cell_b"]["lsthm_a_U_kernel"]).T)

    # the reference's torch format: trainer-level "model." keys
    sd = {"model." + k: v for k, v in model.state_dict().items()}
    sd["loss.weight"] = torch.ones(6)
    torch.save(sd, tmp_path / "ref.model")
    fresh = Predictor(device="cpu", seed=9).model
    logs = []
    loaded = load_parameters(fresh, str(tmp_path / "ref.model"),
                             torch_format=True, log=logs.append)
    assert logs == ["loss.weight is not in the model."]
    assert len(loaded) == len(model.state_dict())
    for k, v in model.state_dict().items():
        torch.testing.assert_close(fresh.state_dict()[k], v, rtol=0, atol=0)
