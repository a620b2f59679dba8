"""bf16 against f32 training to the end (counterpart of
``scripts/convergence_bf16.py``).

    python -m ser_tpu_torch.scripts.convergence_bf16 [--models MARN1_onlysp ...]
        [--seeds 3] [--epochs 20] [--out convergence.json] [--device cpu]

Every run trains one model on one synthetic IEMOCAP set (48 train and 16
test dialogues of 12-24 utterances, batch 8) from seed 111 + s, in f32 and
in ``--compute_dtype bf16`` (``ModelTrainer``'s mixed precision), and
evaluates the test split. A line of JSON a run; then for each model the
mean, least and largest test F1 of each dtype, their gap and whether it lies
within the f32 runs' spread across seeds; the whole document goes to
``--out``, and a last line sums up each model's verdict. The keys are the
JAX script's; ``backend`` is the torch device type. ``--device`` defaults
to ``cuda``. Every random draw is the trainer's (its seeded model init and
dropout generator) or the loaders' (seeded shuffles), so a run depends on
its seed alone.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time

from ser_tpu_torch.data.loaders import get_loaders
from ser_tpu_torch.data.synthetic import generate_iemocap_pickles
from ser_tpu_torch.device import resolve_device
from ser_tpu_torch.train.trainer import ModelTrainer

# the synthetic IEMOCAP set of every run
DATA = dict(n_train=48, n_test=16, min_len=12, max_len=24, seed=7)


def run_one(model_name, seed, compute_dtype, loaders, epochs, device):
    """Train ``epochs`` epochs from ``seed`` and evaluate the test split."""
    train_loader, _, test_loader = loaders
    trainer = ModelTrainer(
        model=model_name, n_classes=6, dataset="IEMOCAP", seed=seed,
        compute_dtype=compute_dtype, res_csv_path=None, device=device)
    t0 = time.time()
    losses = []
    for epoch in range(1, epochs + 1):
        _, loss = trainer.train_network(epoch, train_loader)
        losses.append(loss)
    acc, f1, _ = trainer.eval_network(test_loader)
    return {
        "final_loss": losses[-1],
        "first_loss": losses[0],
        "acc": acc,
        "f1": f1,
        "wall_s": round(time.time() - t0, 1),
    }


def main(argv=None):
    p = argparse.ArgumentParser(description="bf16 against f32 training convergence")
    p.add_argument("--models", nargs="*",
                   default=["MARN1_onlysp", "DialogueRNN", "MARN1_sps"])
    p.add_argument("--seeds", type=int, default=3)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    # one dataset for every run: the runs differ in precision and seed only
    with tempfile.TemporaryDirectory(prefix="ser_conv_") as data_dir:
        feature_path = generate_iemocap_pickles(data_dir, **DATA)
        loaders = get_loaders(feature_path, dataset="IEMOCAP", batch_size=8,
                              valid=0.25, n_classes=6)

        results = {}
        for model_name in args.models:
            results[model_name] = {}
            for dtype in ("f32", "bf16"):
                per_seed = []
                for seed in range(args.seeds):
                    r = run_one(model_name, 111 + seed, dtype, loaders, args.epochs, device)
                    per_seed.append(r)
                    print(json.dumps({"model": model_name, "dtype": dtype,
                                      "seed": 111 + seed, **r}), flush=True)
                f1s = [r["f1"] for r in per_seed]
                results[model_name][dtype] = {
                    "runs": per_seed,
                    "f1_mean": round(sum(f1s) / len(f1s), 2),
                    "f1_min": min(f1s),
                    "f1_max": max(f1s),
                }
            f32, bf16 = results[model_name]["f32"], results[model_name]["bf16"]
            spread = max(f32["f1_max"] - f32["f1_min"], 1e-9)
            gap = f32["f1_mean"] - bf16["f1_mean"]
            results[model_name]["f1_gap_mean"] = round(gap, 2)
            results[model_name]["f32_seed_spread"] = round(spread, 2)
            results[model_name]["within_seed_noise"] = bool(abs(gap) <= spread)
            print(json.dumps({model_name: {
                "f32_f1": f32["f1_mean"], "bf16_f1": bf16["f1_mean"],
                "gap": results[model_name]["f1_gap_mean"],
                "f32_spread": results[model_name]["f32_seed_spread"],
                "within_seed_noise": results[model_name]["within_seed_noise"],
            }}), flush=True)

    doc = {"backend": device.type, "epochs": args.epochs, "seeds": args.seeds,
           "n_train": DATA["n_train"], "n_test": DATA["n_test"], "models": results}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=2)
        print(f"wrote {args.out}")
    print(json.dumps({"summary": {
        m: results[m]["within_seed_noise"] for m in args.models}}))
    return doc


if __name__ == "__main__":
    main()
