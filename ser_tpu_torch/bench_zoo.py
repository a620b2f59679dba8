"""Per-model throughput of the port's zoo on the card, eval or train
(counterpart of ``bench_zoo.py``).

    python -m ser_tpu_torch.bench_zoo [--models MARN1_onlysp DialogueRNN ...] [--iters 20]
    python -m ser_tpu_torch.bench_zoo --save ser_tpu_torch/baselines/zoo_h100.json
    python -m ser_tpu_torch.bench_zoo --check ser_tpu_torch/baselines/zoo_h100.json
    python -m ser_tpu_torch.bench_zoo --train [--dtype bf16] --check FILE

Eval times each model's forward at the IEMOCAP eval shape [82, 31]
(``bench.eval_pass_of``); ``--train`` the whole train step (forward,
backward, Adam, the batch's host-to-device copy) at the reference train
shape [110, 80] (``bench.train_step_of``; MARN_AT with 7 classes, as the
JAX script trains it), in f32 or, with ``--dtype bf16``, in
``ModelTrainer(compute_dtype="bf16")``'s mixed precision. Both are timed as
``bench`` times (its module docstring): ``--iters`` is the least number of
calls in a window (``--train`` halves it), and windows grow to 150 ms
(eval) or 300 ms (train). FLOP shares are of the FP32 peak in both dtypes,
as in the JAX script.

One JSON line a model, then ``{"all": ...}``. A model that raises is tried
once more; where an error is left after that, the run exits 1 after its
lines, and saves and checks nothing.

``--save`` writes ``{"backend", "device", "n_utterances", "dtype",
"models"}``. ``--check`` compares each model's utterances/s with such a
file and exits non-zero below ``--check_threshold``. Before it measures
anything it refuses a file of another dtype, and one recorded on another
backend than this run's: on the card, every file not recorded on ``cuda``,
such as the TPU's ``baselines/zoo_r0*.json``, which are no yardstick for
the port. The device is ``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import sys
import traceback

import numpy as np

from ser_tpu_torch import bench
from ser_tpu_torch.device import disable_tf32, resolve_device
from ser_tpu_torch.models.registry import available_models
from ser_tpu_torch.utils.flops import efficiency


def _row(time_key, t, n_utts, flops):
    """A model's result: ms a call under ``time_key``, utterances/s, the first
    call's seconds and the share of the FP32 peak."""
    return {
        time_key: round(t.seconds * 1e3, 3),
        "utterances_per_sec": round(n_utts / t.seconds, 1),
        "compile_s": round(t.first_s, 3),
        **efficiency(flops, t.seconds),
    }


def bench_model(name, batch, n_utts, iters, device):
    eval_pass, flops = bench.eval_pass_of(name, batch, device)
    t = bench.time_calls(eval_pass, device, bench.EVAL_WINDOW_S, iters, bench.EVAL_CAP)
    return _row("ms_per_pass", t, n_utts, flops)


def bench_model_train(name, batch, n_utts, iters, device, compute_dtype="f32"):
    train_step, flops = bench.train_step_of(name, batch, device, compute_dtype,
                                            n_classes=7 if name == "MARN_AT" else 6)
    t = bench.time_calls(train_step, device, bench.TRAIN_WINDOW_S, iters, bench.TRAIN_CAP)
    return _row("ms_per_step", t, n_utts, flops)


def read_baseline(path, dtype, backend):
    """``--check``'s baseline document, refused where its dtype or backend is
    not this run's."""
    with open(path) as f:
        doc = json.load(f)
    base_dtype = doc.get("dtype", "f32")
    if base_dtype != dtype:
        raise SystemExit(
            f"--check baseline {path} was recorded with dtype={base_dtype} but this "
            f"run uses --dtype {dtype}; gating across dtypes is meaningless (bf16 vs "
            "f32 differ by design). Use a matching baseline.")
    if doc.get("backend") != backend:
        raise SystemExit(
            f"--check baseline {path} was recorded on backend {doc.get('backend')!r} but "
            f"this run is on {backend!r}; a baseline gates runs of its own backend only "
            "(no TPU figure is a yardstick for the port).")
    return doc


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="per-model throughput of the zoo")
    p.add_argument("--models", nargs="*", default=None,
                   help="subset (default: all registered models)")
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--save", type=str, default=None,
                   help="write results JSON (a per-model baseline)")
    p.add_argument("--check", type=str, default=None,
                   help="compare against a saved baseline; flag >10%% drops")
    p.add_argument("--check_threshold", type=float, default=0.9,
                   help="fail --check below this ratio (0.9 = 10%% drop)")
    p.add_argument("--train", action="store_true",
                   help="benchmark the full train step (fwd+bwd+Adam) at the reference "
                        "train shape [110, 80] instead of the eval forward")
    p.add_argument("--dtype", type=str, default="f32", choices=["f32", "bf16"],
                   help="--train only: bf16 measures the mixed-precision path "
                        "(train --compute_dtype bf16). Don't gate a bf16 run "
                        "against an f32 baseline.")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    if args.dtype == "bf16" and not args.train:
        raise SystemExit("--dtype bf16 applies to --train (eval bf16 is the serving "
                         "path: python -m ser_tpu_torch.serve export --dtype bf16)")
    device = resolve_device(args.device)
    disable_tf32()
    base = read_baseline(args.check, args.dtype, device.type) if args.check else None

    if args.train:
        batch = bench.synthetic_like_train(seed=1)
        n_utts = int(np.sum(batch["umask"]))
        iters = max(1, args.iters // 2)
    else:
        batch, n_utts = bench.iemocap_eval_batch()
        iters = args.iters
    results = {}
    for name in (args.models or available_models()):
        for attempt in range(2):  # one retry a model
            try:
                if args.train:
                    results[name] = bench_model_train(name, batch, n_utts, iters, device,
                                                      args.dtype)
                else:
                    results[name] = bench_model(name, batch, n_utts, iters, device)
                break
            except Exception as e:  # keep going; report the failure
                traceback.print_exc()
                results[name] = {"error": f"{type(e).__name__}: {e}"}
                if attempt == 0:
                    print(json.dumps({name: results[name], "retrying": True}), flush=True)
        print(json.dumps({name: results[name]}), flush=True)

    failed = [name for name, res in results.items() if "error" in res]
    if failed:
        print(json.dumps({"all": results}, indent=2))
        print(f"failed after a retry: {failed}", file=sys.stderr)
        return 1

    if args.save:
        with open(args.save, "w") as f:
            json.dump({"backend": device.type,
                       "device": bench.device_name(device),
                       "n_utterances": n_utts,
                       "dtype": args.dtype,
                       "models": results}, f, indent=2)
        print(f"saved baseline -> {args.save}")

    if base is not None:
        print(f"baseline device: {base.get('device')}; this run: {bench.device_name(device)}")
        regressions = []
        for name, res in results.items():
            if "error" in base["models"].get(name, {"error": 1}):
                continue
            ratio = res["utterances_per_sec"] / base["models"][name]["utterances_per_sec"]
            flag = " REGRESSION" if ratio < args.check_threshold else ""
            print(f"{name}: {ratio:.2f}x vs baseline{flag}")
            if ratio < args.check_threshold:
                regressions.append(name)
        if regressions:
            raise SystemExit(f"throughput regressions: {regressions}")

    print(json.dumps({"all": results}, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
