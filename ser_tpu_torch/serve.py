"""Serving CLI of the port (counterpart of the JAX package's ``serve.py``).

    python -m ser_tpu_torch.serve export --initial_model CKPT.npz \\
        --model MARN1_onlysp --out model.ser [--L 110 --B 1,8,32,80] \\
        [--dtype f32|bf16|int8] [--torch_format] [--encoder_attention muse]
    python -m ser_tpu_torch.serve run --artifact model.ser --synthetic [--device cpu]
    python -m ser_tpu_torch.serve bench --artifact model.ser [--iters 50] [--device cpu]
    python -m ser_tpu_torch.serve stream [--n_utts 60] [--max_len 128] \\
        [--initial_model CKPT.npz] [--device cpu]

``export`` loads a checkpoint (the JAX package's ``.npz``, or with
``--torch_format`` a reference torch state dict) and writes the port's
serving artifact (``serving.save_model``: the weights in f32, bf16 or int8
and the [L, B] shape buckets, the encoders' ``--encoder_attention`` kind
in its header); ``run`` evaluates a split with an artifact
(the port's, or a JAX ``SER2`` v3 one) and prints the metrics JSON of
``serve.py run``; ``bench`` prints each bucket's ms a call and utterances
a second: on the card the bucket's CUDA graph replayed ``--iters`` times
between two CUDA events, the lowest of three windows, on the CPU eager
calls on the host clock. ``stream`` drives one synthetic dialogue of
``--n_utts`` utterances through ``streaming.NewZStream`` one utterance at a
time (MARN1_newz with the MHA encoder, the causal encoder contract) and
prints, as ``serve.py
stream`` does, the ms a new utterance (median, p90) and the drift of its
logits from the bidirectional batch forward. The flags are ``serve.py``'s,
plus ``--device`` on ``run``, ``bench`` and ``stream`` (default ``cuda``;
without CUDA it raises unless given ``--device cpu``). ``export
--platforms`` is accepted and not used: the artifact runs on the card and
the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import tempfile
import time

import numpy as np
import torch

from ser_tpu_torch.data.loaders import get_loaders
from ser_tpu_torch.data.synthetic import generate_iemocap_pickles, synthetic_batch
from ser_tpu_torch.device import disable_tf32, resolve_device
from ser_tpu_torch.models.registry import available_models
from ser_tpu_torch.predict import _check_servable
from ser_tpu_torch.serving import PLATFORMS, Predictor, ServingModel, _as_buckets, save_model
from ser_tpu_torch.streaming import NewZStream
from ser_tpu_torch.train.checkpoint import load_parameters
from ser_tpu_torch.train.metrics import weighted_accuracy, weighted_f1
from ser_tpu_torch.utils.seeding import seed_everything

# a dataset's input widths (audio, visual) and parties, for bench's batches
_WIDTHS = {"IEMOCAP": {"d_audio": 100, "d_visual": 512, "n_parties": 2},
           "MELD": {"d_audio": 300, "d_visual": 600, "n_parties": 9}}


def _int_list(s):
    """'80' -> [80]; '1,8,32,80' -> [1, 8, 32, 80] (shape buckets)."""
    return [int(x) for x in str(s).split(",") if x != ""]


def cmd_export(args):
    """A checkpoint as a serving artifact; prints ``serve.py export``'s
    JSON line."""
    _check_servable(args)
    predictor = Predictor(args.model, seed=args.seed, device="cpu", n_classes=args.n_classes,
                          encoder_attention=args.encoder_attention)
    load_parameters(predictor.model, args.initial_model, torch_format=args.torch_format)
    Ls, Bs = _int_list(args.L), _int_list(args.B)
    save_model(args.out, args.model, predictor.model.state_dict(), Ls, Bs,
               n_classes=args.n_classes, dataset=args.dataset, dtype=args.dtype)
    print(json.dumps({"artifact": args.out, "model": args.model,
                      "buckets": [list(lb) for lb in _as_buckets(Ls, Bs)],
                      "platforms": ",".join(PLATFORMS), "dtype": args.dtype}))


def cmd_run(args):
    """Evaluate ``--split`` with an artifact, batches of its largest B; prints
    ``serve.py run``'s JSON."""
    device = resolve_device(args.device)
    disable_tf32()
    seed_everything(args.seed)
    served = ServingModel.load(args.artifact, device=device)
    h = served.header
    with contextlib.ExitStack() as stack:
        if args.synthetic:
            args.feature_path = generate_iemocap_pickles(
                stack.enter_context(tempfile.TemporaryDirectory(prefix="ser_tpu_torch_serve_")),
                seed=args.seed)
        _, valid_loader, test_loader = get_loaders(
            args.feature_path, dataset=h["dataset"], valid=0.2, batch_size=h["B"],
            n_classes=h["n_classes"], seed=args.seed, roberta_path=args.roberta_path)
        loader = {"test": test_loader, "valid": valid_loader}[args.split]
        preds, labels, masks = [], [], []
        for batch in loader:
            out = served.predict(batch)
            preds.append(out["preds"].reshape(-1))
            labels.append(np.asarray(batch["label"]).reshape(-1))
            masks.append(np.asarray(batch["umask"]).reshape(-1))
    preds, labels, masks = (np.concatenate(x) for x in (preds, labels, masks))
    print(json.dumps({
        "artifact": args.artifact,
        "model": h["model"],
        "split": args.split,
        "n_utterances": int(masks.sum()),
        "weighted_accuracy": weighted_accuracy(labels, preds, masks),
        "weighted_f1": weighted_f1(labels, preds, masks),
    }, indent=2))


def _lowest_window_s(fn, iters, clock) -> float:
    """Seconds a call of ``fn``: ``iters`` calls a window, the lowest of 3
    windows, after one warm-up call; ``clock(run)`` gives a window's
    seconds."""
    fn()
    return min(clock(lambda: [fn() for _ in range(iters)]) for _ in range(3)) / iters


def _host_s(run) -> float:
    t0 = time.perf_counter()
    run()
    return time.perf_counter() - t0


def _cuda_s(run) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def cmd_bench(args):
    """Each bucket's latency on a synthetic batch of its shape (the
    dataset's widths): on the card the bucket's CUDA graph replayed between
    two CUDA events, on the CPU eager calls on the host clock; prints
    ``serve.py bench``'s JSON."""
    device = resolve_device(args.device)
    disable_tf32()
    served = ServingModel.load(args.artifact, device=device)
    h = served.header
    rows = {}
    for (L, B) in served.buckets:
        batch = synthetic_batch(L=L, B=B, n_classes=h["n_classes"], **_WIDTHS[h["dataset"]])
        x, qmask, umask = served._make_inputs(batch)
        if device.type == "cuda":
            graph = served.graph((L, B), x.shape[-1], qmask.shape[-1])
            graph(x, qmask, umask)  # the batch into the graph's inputs
            sec = _lowest_window_s(graph.replay, args.iters, _cuda_s)
        else:
            sec = _lowest_window_s(lambda: served.bucket_forward((L, B), x, qmask, umask),
                                   args.iters, _host_s)
        sec = max(sec, 1e-9)
        rows[f"L{L}_B{B}"] = {
            "ms_per_call": round(sec * 1e3, 3),
            "utterances_per_sec": round(float(umask.sum()) / sec, 1),
        }
    print(json.dumps({"artifact": args.artifact, "model": h["model"],
                      "backend": device.type, "buckets": rows}, indent=2))


def cmd_stream(args):
    """One dialogue through ``NewZStream``: ms a new utterance, and the
    argmax agreement and largest logit difference against the
    bidirectional (reference-encoder) batch forward on the same input."""
    if args.model != "MARN1_newz":
        raise SystemExit(
            "stream supports the unidirectional MARN1_newz only; every "
            "other registry model is bidirectional (backward scan over the "
            "full dialogue) and must use the bucket path (serve.py run)")
    if args.n_classes != 6:
        raise ValueError(
            f"--n_classes {args.n_classes}: MARN1_newz has 6 logits whatever "
            "--n_classes says (the JAX registry's quirk), and serve.py stream "
            "cannot reshape them to another count")
    device = resolve_device(args.device)
    disable_tf32()
    predictor = Predictor(args.model, seed=args.seed, device=device)
    if args.initial_model:
        load_parameters(predictor.model, args.initial_model,
                        torch_format=args.torch_format)

    rng = np.random.default_rng(args.seed)
    L = args.n_utts
    x = rng.standard_normal((L, 1124)).astype(np.float32)
    sp = rng.integers(0, 2, size=L)
    qmask = np.zeros((L, 2), dtype=np.float32)
    qmask[np.arange(L), sp] = 1.0

    stream = NewZStream(predictor.model, max_len=max(L, args.max_len))
    stream.append(x[0], qmask[0])  # warm-up
    stream.reset()
    t_per, logits = [], []
    for t in range(L):
        t0 = time.perf_counter()
        logits.append(stream.append(x[t], qmask[t]))
        t_per.append(time.perf_counter() - t0)
    logits = np.stack(logits)

    out = predictor.predict(x[:, None, :], qmask[:, None, :], np.ones((1, L), np.float32))[0]
    bi = out.cpu().numpy().reshape(L, -1)
    print(json.dumps({
        "model": args.model,
        "n_utterances": L,
        "ms_per_new_utterance_median": round(float(np.median(t_per)) * 1e3, 3),
        "ms_per_new_utterance_p90": round(float(np.percentile(t_per, 90)) * 1e3, 3),
        "argmax_agreement_vs_bidirectional": round(
            float((logits.argmax(-1) == bi.argmax(-1)).mean()), 4),
        "max_logit_drift_vs_bidirectional": float(np.abs(logits - bi).max()),
        "contract": "equals MARN1NewZ(causal_encoder=True) batch forward "
                    "(tests/test_torch_streaming.py)",
    }, indent=2))


def main(argv=None):
    p = argparse.ArgumentParser(description="ser_tpu_torch serving (PyTorch/CUDA port)")
    sub = p.add_subparsers(dest="cmd", required=True)

    pe = sub.add_parser("export", help="checkpoint -> serving artifact")
    pe.add_argument("--initial_model", type=str, required=True)
    pe.add_argument("--out", type=str, required=True)
    pe.add_argument("--model", type=str, default="MARN1_onlysp",
                    help=" / ".join(available_models()))
    pe.add_argument("--dataset", type=str, default="IEMOCAP")
    pe.add_argument("--n_classes", type=int, default=6)
    pe.add_argument("--L", type=str, default="110",
                    help="dialogue-length bucket(s), comma-separated (e.g. 110 or 32,110)")
    pe.add_argument("--B", type=str, default="1,8,32,80",
                    help="batch-size bucket(s), comma-separated; predict picks the "
                         "smallest admitting bucket")
    pe.add_argument("--seed", type=int, default=111)
    pe.add_argument("--platforms", type=str, default=",".join(PLATFORMS),
                    help="accepted for serve.py's command line; the artifact runs on "
                         "the card and the CPU")
    pe.add_argument("--torch_format", action="store_true")
    pe.add_argument("--encoder_attention", type=str, default="mha",
                    help="the kind the checkpoint was trained with; recorded in "
                         "the artifact's header")
    pe.add_argument("--dtype", type=str, default="f32", choices=["f32", "bf16", "int8"],
                    help="f32; bf16 = weights rounded to bf16, forward under bf16 "
                         "autocast (f32 in and out); int8 = weights-only int8 storage, "
                         "dequantized to bf16 at load")
    pe.set_defaults(fn=cmd_export)

    pr = sub.add_parser("run", help="evaluate a split with an artifact")
    pr.add_argument("--artifact", type=str, required=True)
    pr.add_argument("--feature_path", type=str, default="/home/workspaces/SMM22/features/")
    pr.add_argument("--roberta_path", type=str, default=None)
    pr.add_argument("--split", type=str, default="test", choices=["test", "valid"])
    pr.add_argument("--seed", type=int, default=111)
    pr.add_argument("--synthetic", action="store_true")
    pr.add_argument("--device", type=str, default="cuda")
    pr.set_defaults(fn=cmd_run)

    pb = sub.add_parser("bench", help="per-bucket serving latency")
    pb.add_argument("--artifact", type=str, required=True)
    pb.add_argument("--iters", type=int, default=50)
    pb.add_argument("--device", type=str, default="cuda")
    pb.set_defaults(fn=cmd_bench)

    ps = sub.add_parser("stream", help="stateful streaming session (MARN1_newz)")
    ps.add_argument("--initial_model", type=str, default=None)
    ps.add_argument("--model", type=str, default="MARN1_newz")
    ps.add_argument("--n_classes", type=int, default=6)
    ps.add_argument("--dataset", type=str, default="IEMOCAP")
    ps.add_argument("--n_utts", type=int, default=60, help="dialogue length to drive")
    ps.add_argument("--max_len", type=int, default=128,
                    help="history capacity (static shape)")
    ps.add_argument("--seed", type=int, default=111)
    ps.add_argument("--torch_format", action="store_true")
    ps.add_argument("--device", type=str, default="cuda")
    ps.set_defaults(fn=cmd_stream)
    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
