"""``--encoder_attention`` in the port against the JAX package, on the CPU.

The five zoo kinds (``ops/encoder_attention.py``): each ``ZooSelfAttention``
alone at [2, 8, 100] against the JAX one with the same weights (output at
rtol 1e-5, atol 1e-6; input and parameter gradients of a fixed linear
functional, dropout off, within 1e-4 of each tensor's largest entry plus
1e-6 of the largest of all); the whole MARN1_onlysp eval forward under each
kind (rtol 1e-3, atol 1e-4, the port's logit contract), its zoo op's weights
drawn large (``enlarge_zoo_ops``) so that the op moves the log-probs past
that tolerance; one muse train step
(``tests/test_torch_train_step.py``'s contract: loss, gradients, dead set,
updates); MARN1_newz under ``external``, whose causal encoder is then not
causal in either package; the keys of all 15 models under ``muse``; the
checkpoint both ways, with the tolerant loader's "is not in the model" lines
when the kind is left off (``tests/test_encoder_attention.py::
test_predict_cli_honors_encoder_attention``); and a JAX ``SER2`` v3
``external`` artifact read by the port with its kind inferred from the
weights' names, whose weights section the port writes byte for byte; a
``SERT`` header whose kind is not its weights' refused.

JAX weights reach the port through ``compat.from_jax.from_jax_params``.
``ser_tpu.config.ENCODER_ATTENTION`` is process-global and ``--dist
loadfile`` shares a worker's process between files, so a fixture restores
it to ``"mha"`` after every test.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ser_tpu import config
from ser_tpu.data.synthetic import synthetic_batch as jsynthetic_batch
from ser_tpu.models.registry import available_models, get_model_spec as jget_model_spec
from ser_tpu.ops.encoder_attention import ZooSelfAttention as JZooSelfAttention
from ser_tpu.train import checkpoint as jckpt
from ser_tpu.train.checkpoint import flatten_params, unflatten_into
from ser_tpu_torch import predict as tpredict
from ser_tpu_torch.compat.from_jax import from_jax_params, to_jax_params
from ser_tpu_torch.data.synthetic import generate_iemocap_pickles, synthetic_batch
from ser_tpu_torch.models.registry import build_model
from ser_tpu_torch.ops.encoder_attention import (SEQUENCE_KINDS, ZooSelfAttention,
                                                 encoder_attention_of)
from ser_tpu_torch.ops.init import generator
from ser_tpu_torch.serving import Predictor, ServingModel, save_model
from ser_tpu_torch.train.checkpoint import save_parameters
from test_torch_train_step import LR, grad_tolerance, port_grads, run_step

ZOO = tuple(k for k in SEQUENCE_KINDS if k != "mha")
D = 100


@pytest.fixture(autouse=True)
def restore_config():
    yield
    config.ENCODER_ATTENTION = "mha"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.cache
def _jax_zoo(kind):
    """``(JAX module, its params, x, cotangent)`` at [2, 8, 100], made once a
    kind (a JAX init compiles)."""
    rng = np.random.default_rng(SEQUENCE_KINDS.index(kind))
    x = rng.standard_normal((2, 8, D)).astype(np.float32)
    jmod = JZooSelfAttention(kind, D)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    # the weights made larger than the zoo's N(0, 0.001) init, so the op's
    # own terms reach the output past the residual
    params = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(np.float32)
                              / max(p.shape[0], 1) ** 0.5), params)
    return jmod, params, x, rng.standard_normal(x.shape).astype(np.float32)


def _zoo_pair(kind):
    """``(JAX module, its params, port module with them, x, cotangent)``."""
    jmod, params, x, cot = _jax_zoo(kind)
    state = from_jax_params({f"slf_attn/{k}": v for k, v in flatten_params(params).items()})
    port = ZooSelfAttention(kind, D, generator=generator(0)).eval()
    port.load_state_dict({k[len("slf_attn."):]: v for k, v in state.items()}, strict=True)
    return jmod, params, port, x, cot


@pytest.mark.parametrize("kind", ZOO)
def test_zoo_op_output_matches_jax(kind):
    jmod, params, port, x, _ = _zoo_pair(kind)
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ZOO)
def test_zoo_op_gradients_match_jax(kind):
    """d sum(out·c) / d(x, every parameter), dropout off."""
    jmod, params, port, x, cot = _zoo_pair(kind)

    def f(p, xx):
        return jnp.sum(jmod.apply({"params": p}, xx) * cot)

    jg_p, jg_x = jax.grad(f, argnums=(0, 1))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    (port(xt) * torch.from_numpy(cot)).sum().backward()
    want = {f"slf_attn/{k}": np.asarray(v) for k, v in flatten_params(jg_p).items()}
    got = to_jax_params({f"slf_attn.{n}": p.grad for n, p in port.named_parameters()})
    assert sorted(got) == sorted(want)
    want["x"], got["x"] = np.asarray(jg_x), xt.grad.numpy()
    top = max(np.abs(w).max() for w in want.values())
    for name, w in want.items():
        tol = 1e-4 * np.abs(w).max() + 1e-6 * top
        np.testing.assert_array_less(np.abs(got[name] - w), tol, err_msg=name)


def enlarge_zoo_ops(params, seed=0):
    """The zoo ops' parameters (``slf_attn/op/``) drawn N(0, 100/fan-in), a
    vector's N(0, 100/size): ten times ``_jax_zoo``'s draw. At the zoo's
    N(0, 0.001²) init an op adds about 1e-4 before the encoder's residual and
    LayerNorm, which a whole-forward comparison at atol 1e-4 cannot see; the
    head damps the encoders' output, and at this scale every kind moves the
    log-probs by 0.05 or more."""
    rng = np.random.default_rng(seed)
    flat = flatten_params(params)
    for name, v in flat.items():
        if "slf_attn/op/" in name:
            flat[name] = (10 * rng.standard_normal(v.shape) / v.shape[0] ** 0.5
                          ).astype(np.float32)
    return unflatten_into(params, flat)


def assert_op_moves_the_output(got, state_at_init, args, valid, name="MARN1_onlysp"):
    """The port's log-probs at the zoo's init lie more than 2e-2 from ``got``
    on a valid row, ten times the comparison's tolerance there: it sees the
    op."""
    kind = encoder_attention_of(state_at_init)
    at_init = Predictor(name, state_dict=state_at_init, device="cpu",
                        encoder_attention=kind).predict(*map(np.asarray, args))[0].numpy()
    assert np.abs(at_init - got)[valid].max() > 2e-2, kind


def _onlysp_inputs():
    batch = jsynthetic_batch(L=6, B=2, seed=3)
    batch["umask"][1, 4:] = 0.0  # a padded tail
    return jget_model_spec("MARN1_onlysp").make_inputs(
        {k: jnp.asarray(v) for k, v in batch.items() if k != "vid"})


@pytest.mark.parametrize("kind", ZOO)
def test_onlysp_eval_forward_matches_jax(kind):
    config.ENCODER_ATTENTION = kind
    args = _onlysp_inputs()
    model = jget_model_spec("MARN1_onlysp").build(6, "IEMOCAP")
    key = jax.random.PRNGKey(2)
    at_init = model.init({"params": key, "dropout": key}, *args, deterministic=True)["params"]
    params = enlarge_zoo_ops(at_init)
    want = np.asarray(model.apply({"params": params}, *args, deterministic=True)[0])
    pred = Predictor(state_dict=from_jax_params(flatten_params(params)), device="cpu",
                     encoder_attention=kind)
    assert encoder_attention_of(pred.model.state_dict()) == kind
    logp, _ = pred.predict(*map(np.asarray, args))
    valid = np.asarray(args[2]).reshape(-1) > 0
    np.testing.assert_allclose(logp.numpy()[valid], want[valid], rtol=1e-3, atol=1e-4)
    assert_op_moves_the_output(logp.numpy(), from_jax_params(flatten_params(at_init)), args,
                               valid)


# MARN1_onlysp's all-zero gradients under muse: the parameters the reference
# declares and never uses (crossatt_l2a.Wv, crossatt_a2l, lstm_q0/q1/s,
# pos_ffn.fc, linear), as under mha; every zoo parameter learns
MUSE_DEAD = 38


@pytest.fixture(scope="module")
def muse_step(tmp_path_factory):
    return run_step(str(tmp_path_factory.mktemp("muse") / "res.csv"), encoder_attention="muse")


def test_muse_train_step_matches_jax(muse_step):
    step = muse_step
    np.testing.assert_allclose(step["loss"].item(), step["jloss"], rtol=1e-5)
    grads = port_grads(step["pt"].model)
    assert sorted(grads) == sorted(step["jgrads"])
    assert sum("slf_attn/op/" in n for n in grads) == 2 * 19  # q, k, v, o, dy, 3 convs
    tol = grad_tolerance(step["jgrads"])
    for name, g in grads.items():
        if g is not None:
            np.testing.assert_array_less(np.abs(g - np.asarray(step["jgrads"][name])),
                                         tol[name], err_msg=name)
    dead = {n for n, g in grads.items() if g is None}
    assert dead == {n for n, g in step["jgrads"].items() if not np.any(np.asarray(g))}
    assert len(dead) == MUSE_DEAD and not any("slf_attn" in n for n in dead)
    after = to_jax_params(step["pt"].model.state_dict())
    for name, want in step["new_params"].items():
        np.testing.assert_array_less(np.abs(after[name] - np.asarray(want)), 2.05 * LR,
                                     err_msg=name)


def test_newz_external_matches_jax_and_ignores_the_causal_mask():
    config.ENCODER_ATTENTION = "external"
    batch = jsynthetic_batch(L=7, B=2, seed=5)
    spec = jget_model_spec("MARN1_newz")
    args = spec.make_inputs({k: jnp.asarray(v) for k, v in batch.items() if k != "vid"})
    model = spec.build(6, "IEMOCAP")
    key = jax.random.PRNGKey(4)
    at_init = model.init({"params": key, "dropout": key}, *args, deterministic=True)["params"]
    params = enlarge_zoo_ops(at_init)
    want = np.asarray(model.apply({"params": params}, *args, deterministic=True)[0])
    state = from_jax_params(flatten_params(params))
    pred = Predictor("MARN1_newz", state_dict=state, device="cpu", encoder_attention="external")
    got = pred.predict(*map(np.asarray, args))[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
    assert_op_moves_the_output(got, from_jax_params(flatten_params(at_init)), args,
                               np.ones(got.shape[0], bool), "MARN1_newz")
    # the zoo op ignores the encoder's mask: the causal model is the same
    from ser_tpu_torch.models.marn_newz import MARN1NewZ
    causal = MARN1NewZ(6, causal_encoder=True, generator=generator(0),
                       encoder_attention="external").eval()
    causal.load_state_dict(state, strict=True)
    with torch.no_grad():
        again = causal(*(torch.from_numpy(np.asarray(a)) for a in args))[0].numpy()
    np.testing.assert_array_equal(again, got)


@pytest.mark.parametrize("name", available_models())
def test_every_model_keys_match_jax(name):
    """``from_jax_params`` of the JAX parameter tree under ``muse`` (whose
    op has every kind of zoo leaf: Linears, convolutions, ``dy_paras``) is
    the port model's state dict, keys and shapes, wherever the model keeps
    its encoders (at the root, in azs's, mf's and la's cells, newz's and
    MARN_ATV's 512-wide one); ``to_jax_params`` inverts it; the keys name the
    kind. An unknown kind raises with the JAX message."""
    config.ENCODER_ATTENTION = "muse"
    batch = {k: jnp.asarray(v) for k, v in jsynthetic_batch(L=4, B=2, seed=0).items()
             if k != "vid"}
    key = jax.random.PRNGKey(0)
    spec = jget_model_spec(name)
    shapes = jax.eval_shape(lambda: spec.build(6, "IEMOCAP").init(
        {"params": key, "dropout": key}, *spec.make_inputs(batch),
        deterministic=True))["params"]
    rng = np.random.default_rng(1)
    flat = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in
            flatten_params(jax.tree_util.tree_map(
                lambda s: np.zeros(s.shape, np.float32), shapes)).items()}
    state = from_jax_params(flat)
    model = build_model(name, generator(0), 6, "muse")
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in state.items()} == want
    back = to_jax_params(state)
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    assert encoder_attention_of(state) == ("mha" if name == "DialogueRNN" else "muse")
    with pytest.raises(ValueError, match=r"unknown encoder attention 'mhb'; choose from"):
        build_model(name, generator(0), 6, "mhb")


def test_checkpoint_both_ways_and_the_predict_cli(tmp_path, capsys):
    """A JAX ``external`` checkpoint through the port's predict CLI: with
    ``--encoder_attention external`` every name loads, without it the
    loader says which it skips; a port ``external`` checkpoint loads into
    the JAX package's tree with no warning and equal values."""
    from ser_tpu.train.trainer import ModelTrainer as JModelTrainer

    config.ENCODER_ATTENTION = "external"
    jt = JModelTrainer(model="MARN1_onlysp", seed=3, res_csv_path=None)
    jpath = str(tmp_path / "jax.model")
    jt.save_parameters(jpath)
    feats = generate_iemocap_pickles(str(tmp_path / "feats"), seed=2, n_train=4, n_test=3,
                                     min_len=3, max_len=8)
    common = ["--initial_model", jpath, "--feature_path", feats, "--batch_size", "4",
              "--device", "cpu", "--res_csv", str(tmp_path / "res.csv")]
    tpredict.main(common + ["--encoder_attention", "external"])
    out = capsys.readouterr().out
    assert "is not in the model" not in out, out
    assert np.isfinite(json.loads(out[out.index("{"):])["weighted_accuracy"])
    tpredict.main(common)
    assert "is not in the model" in capsys.readouterr().out

    port = build_model("MARN1_onlysp", generator(5), 6, "external")
    tpath = str(tmp_path / "port.model")
    save_parameters(port, tpath)
    warnings = []
    loaded = jckpt.load_parameters(jt.params, tpath, log=warnings.append)
    assert not warnings, warnings
    want = to_jax_params(port.state_dict())
    for name, v in flatten_params(loaded).items():
        np.testing.assert_array_equal(np.asarray(v), want[name], err_msg=name)


def test_jax_ser2_external_artifact_kind_inferred(tmp_path):
    """A JAX ``SER2`` v3 artifact under ``external`` at one bucket: the port
    reads its kind from the weights' names and answers as the JAX artifact
    does; the port's export of the same weights records the kind and holds
    the same weights section byte for byte."""
    from ser_tpu.serving import ServingModel as JServingModel
    from ser_tpu.serving import save_model as jsave_model
    from ser_tpu.train.trainer import ModelTrainer as JModelTrainer

    config.ENCODER_ATTENTION = "external"
    jt = JModelTrainer(model="MARN1_onlysp", seed=4, res_csv_path=None)
    jpath = str(tmp_path / "jax.ser")
    jsave_model(jpath, "MARN1_onlysp", enlarge_zoo_ops(jt.params), 8, 2, platforms=("cpu",))
    served = ServingModel.load(jpath, device="cpu")
    assert served.header["encoder_attention"] == "external"
    assert served.predictor.encoder_attention == "external"
    batch = synthetic_batch(L=7, B=2, seed=6)
    want = JServingModel.load(jpath).predict(batch)["logp"]
    got = served.predict(batch)["logp"]
    valid = batch["umask"] > 0
    np.testing.assert_allclose(got[valid], np.asarray(want)[valid], rtol=1e-3, atol=1e-4)

    tpath = str(tmp_path / "port.ser")
    save_model(tpath, "MARN1_onlysp", served.model.state_dict(), 8, 2)
    sections = []
    for path in (jpath, tpath):
        data = open(path, "rb").read()
        (hlen,) = np.frombuffer(data[4:8], "<u4")
        (plen,) = np.frombuffer(data[8 + hlen:16 + hlen], "<u8")
        sections.append((json.loads(data[8:8 + hlen]), data[16 + hlen:16 + hlen + plen]))
    (jheader, jweights), (theader, tweights) = sections
    assert "encoder_attention" not in jheader and theader["encoder_attention"] == "external"
    assert theader["params"] == jheader["params"] and tweights == jweights


@pytest.mark.parametrize("header_kind", ["muse", "mha"])
def test_artifact_header_kind_must_be_its_weights(tmp_path, header_kind):
    """A ``SERT`` header whose ``encoder_attention`` is not the kind its
    weights' names hold is refused, whichever way they disagree."""
    path = str(tmp_path / "a.ser")
    save_model(path, "MARN1_onlysp", build_model("MARN1_onlysp", generator(0), 6,
                                                 "external").state_dict(), 8, 2)
    data = open(path, "rb").read()
    (hlen,) = np.frombuffer(data[4:8], "<u4")
    header = json.loads(data[8:8 + hlen])
    assert header["encoder_attention"] == "external"
    header["encoder_attention"] = header_kind
    raw = json.dumps(header).encode()
    open(path, "wb").write(data[:4] + np.uint32(len(raw)).tobytes() + raw + data[8 + hlen:])
    with pytest.raises(ValueError, match=f"encoder_attention '{header_kind}' is not its "
                                         "weights' 'external'"):
        ServingModel.load(path, device="cpu")
