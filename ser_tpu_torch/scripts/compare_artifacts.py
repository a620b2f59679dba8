"""How far serving artifacts of one model drift apart: f32 against bf16
against int8 (counterpart of ``scripts/compare_artifacts.py``).

    python -m ser_tpu_torch.scripts.compare_artifacts m_f32.ser m_bf16.ser m_int8.ser \\
        [--device cpu]

Loads each artifact (``SERT``, or the JAX package's ``SER2`` v3) with
``serving.ServingModel.load``, answers one synthetic batch at the first
artifact's largest bucket (``synthetic_batch(L, B, n_classes, seed=3)``)
with each, and prints, for each artifact after the first, the largest and
the mean |log-prob| difference from the first and the argmax agreement,
over the valid rows (``umask``); then the report as one JSON line, with
the JAX script's keys. Every artifact must be of the first one's model.
``--device`` defaults to ``cuda``.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from ser_tpu_torch.data.synthetic import synthetic_batch
from ser_tpu_torch.device import resolve_device
from ser_tpu_torch.serving import ServingModel


def main(argv=None):
    p = argparse.ArgumentParser(description="log-prob drift between serving artifacts")
    p.add_argument("paths", nargs="+")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    served = [ServingModel.load(path, device=device) for path in args.paths]
    h0 = served[0].header
    L, B = served[0].buckets[-1]
    batch = synthetic_batch(L=L, B=B, n_classes=h0["n_classes"], seed=3)
    outs = []
    for path, s in zip(args.paths, served):
        if s.header["model"] != h0["model"]:
            raise ValueError(f"{path} holds {s.header['model']}, not {h0['model']}")
        outs.append((path, s.header.get("dtype", "f32"), s.predict(batch)["logp"]))

    base_path, base_dtype, base = outs[0]
    report = {"model": h0["model"], "shape": [L, B],
              "baseline": {"path": base_path, "dtype": base_dtype}}
    valid = np.asarray(batch["umask"]) > 0
    for path, dtype, logp in outs[1:]:
        d = np.abs(logp - base)[valid]
        agree = float((logp.argmax(-1) == base.argmax(-1))[valid].mean())
        report[dtype] = {
            "path": path,
            "max_logp_drift": float(d.max()),
            "mean_logp_drift": float(d.mean()),
            "argmax_agreement": round(agree, 4),
        }
        print(f"{dtype:>5s} vs {base_dtype}: maxdrift {d.max():.4g} "
              f"mean {d.mean():.4g} argmax agree {agree:.2%}", flush=True)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
