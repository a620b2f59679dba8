"""Serving CLI of the port (counterpart of the JAX package's ``serve.py``).

    python -m ser_tpu_torch.serve stream [--n_utts 60] [--max_len 128] \\
        [--initial_model CKPT.npz] [--device cpu]

``stream`` drives one synthetic dialogue of ``--n_utts`` utterances through
``streaming.NewZStream`` one utterance at a time (MARN1_newz, the causal
encoder contract) and prints, as ``serve.py stream`` does, the ms a new
utterance (median, p90) and the drift of its logits from the
bidirectional batch forward. The flags are ``serve.py stream``'s plus
``--device`` (default ``cuda``; without CUDA it raises unless given
``--device cpu``). ``export``, ``run`` and ``bench`` (the AOT artifact
path) are not ported yet: they raise, naming ROADMAP A.15.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from ser_tpu_torch.device import disable_tf32, resolve_device
from ser_tpu_torch.serving import Predictor
from ser_tpu_torch.streaming import NewZStream
from ser_tpu_torch.train.checkpoint import load_parameters


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


def _not_ported(name):
    def refuse(args):
        raise NotImplementedError(
            f"serve {name}: the AOT artifact path (export, run, bench) is not "
            "ported yet; queued (ROADMAP A.15)")
    return refuse


def main(argv=None):
    p = argparse.ArgumentParser(description="ser_tpu_torch serving (PyTorch/CUDA port)")
    sub = p.add_subparsers(dest="cmd", required=True)
    for name in ("export", "run", "bench"):
        sub.add_parser(name, help="not ported yet (ROADMAP A.15)").set_defaults(
            fn=_not_ported(name))
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
