"""Result analysis of an eval dump (counterpart of the JAX package's
``analysis.py``; the reference's ``demo.ipynb`` as a CLI).

    python -m ser_tpu_torch.analysis --res res.csv [--parameters parameters.csv]
                                     [--out analysis_out] [--labels hap sad neu ang exc fru]

Reads the ``res.csv`` that the predict and train CLIs write (``preds``,
``labels``, ``masks``) and prints a JSON report: the rows, the valid rows,
weighted accuracy and F1, each class's accuracy over its valid rows and
their mean, the JAX CLI's keys and values. With ``--out`` (default
``analysis_out``; an empty value writes no plot) it also saves the
confusion-matrix percent plot there and, from ``parameters.csv``, the
fusion weights' trajectories; only the plots need matplotlib. The files are
read with the ``csv`` module.
"""

from __future__ import annotations

import argparse
import csv
import json
import os

import numpy as np

from ser_tpu_torch.train.metrics import weighted_accuracy, weighted_f1

IEMOCAP_LABELS = ["hap", "sad", "neu", "ang", "exc", "fru"]


def _columns(path):
    """``{header: float64 column}`` of a CSV file; ``{}`` for an empty
    file."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    if not rows:
        return {}
    return {name: np.asarray([float(r[i]) for r in rows[1:]], dtype=np.float64)
            for i, name in enumerate(rows[0])}


def analyze_res(res_path, labels=None, out_dir=None):
    """The report of ``res_path`` (the module docstring); with ``out_dir``
    the confusion plot is saved there and its path added."""
    cols = _columns(res_path)
    preds, golds, masks = cols["preds"], cols["labels"], cols["masks"]
    report = {
        "n_rows": len(preds),
        "n_valid": int(masks.sum()),
        "weighted_accuracy": weighted_accuracy(golds, preds, masks),
        "weighted_f1": weighted_f1(golds, preds, masks),
    }
    classes = np.unique(golds[masks > 0])
    per_class = {int(c): round(float((preds[(golds == c) & (masks > 0)] == c).mean()) * 100, 2)
                 for c in classes}
    report["per_class_accuracy"] = per_class
    report["mean_per_class_accuracy"] = round(float(np.mean(list(per_class.values()))), 2)

    if out_dir:
        from ser_tpu_torch.utils.confusion import cm_analysis

        os.makedirs(out_dir, exist_ok=True)
        names = labels or [str(int(c)) for c in classes]
        valid = masks > 0
        cm_analysis([names[int(g)] for g in golds[valid]], [names[int(p)] for p in preds[valid]],
                    os.path.join(out_dir, "confusion"), names)
        report["confusion_plot"] = os.path.join(out_dir, "confusion.png")
    return report


def plot_parameters(parameters_path, out_dir):
    """The fusion weights of each eval (``parameters.csv``, a column a
    weight) plotted to ``out_dir/fusion_weights.png``; None where the file
    holds no rows (the reference's own ships empty)."""
    cols = _columns(parameters_path)
    if not cols or not len(next(iter(cols.values()))):
        return None
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    fig, ax = plt.subplots(figsize=(8, 5))
    for name, values in cols.items():
        ax.plot(values, label=name)
    ax.set_xlabel("eval step")
    ax.set_ylabel("fusion weight")
    ax.legend()
    fig.tight_layout()
    path = os.path.join(out_dir, "fusion_weights.png")
    fig.savefig(path)
    plt.close(fig)
    return path


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--res", default="res.csv")
    p.add_argument("--parameters", default=None)
    p.add_argument("--out", default="analysis_out")
    p.add_argument("--labels", nargs="*", default=IEMOCAP_LABELS)
    args = p.parse_args(argv)

    report = analyze_res(args.res, labels=args.labels, out_dir=args.out)
    if args.out and args.parameters and os.path.exists(args.parameters):
        path = plot_parameters(args.parameters, args.out)
        if path:
            report["fusion_weights_plot"] = path
    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
