"""The confusion matrix and its percent plot (counterpart of
``ser_tpu/utils/confusion.py``; ref ``utils.py:40-90``).

``confusion_matrix`` counts in numpy; ``cm_analysis`` normalises each row
to percent and saves it as ``<filename>.pdf`` and ``.png`` through
matplotlib's Agg backend, which it imports only when called.
"""

from __future__ import annotations

import numpy as np


def confusion_matrix(y_true, y_pred, labels):
    """Counts ``[k, k]``: row the true label, column the predicted, in the
    order of ``labels``; a pair with a label outside ``labels`` is not
    counted."""
    index = {c: i for i, c in enumerate(labels)}
    cm = np.zeros((len(labels), len(labels)), dtype=np.int64)
    for t, p in zip(np.asarray(y_true), np.asarray(y_pred)):
        if t in index and p in index:
            cm[index[t], index[p]] += 1
    return cm


def cm_analysis(y_true, y_pred, filename, labels, ymap=None, figsize=(10, 10)):
    """Plot the row-normalised confusion matrix in percent to
    ``filename``.pdf and .png; returns the percentages. ``ymap`` renames the
    labels first."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if ymap is not None:
        y_pred = [ymap[yi] for yi in y_pred]
        y_true = [ymap[yi] for yi in y_true]
        labels = [ymap[yi] for yi in labels]
    cm = confusion_matrix(y_true, y_pred, labels)
    cm_perc = cm / np.maximum(cm.sum(axis=1, keepdims=True), 1).astype(float) * 100

    fig, ax = plt.subplots(figsize=figsize)
    fontsize = 17
    im = ax.imshow(cm_perc, cmap="bone_r", vmin=0, vmax=100)
    ax.set_xticks(range(len(labels)), labels, fontsize=fontsize)
    ax.set_yticks(range(len(labels)), labels, fontsize=fontsize)
    ax.set_xlabel("Predicted", fontsize=fontsize)
    ax.set_ylabel("Actual", fontsize=fontsize)
    for i in range(len(labels)):
        for j in range(len(labels)):
            ax.text(j, i, "%.1f%%" % cm_perc[i, j], ha="center", va="center", fontsize=10)
    fig.colorbar(im)
    fig.tight_layout()
    fig.savefig(f"{filename}.pdf")
    fig.savefig(f"{filename}.png")
    plt.close(fig)
    return cm_perc
