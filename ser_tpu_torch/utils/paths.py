"""Save-path derivation (counterpart of ``ser_tpu/utils/paths.py``)."""

from __future__ import annotations

import os


def init_args(args):
    """``score_save_path`` and ``model_save_path`` under ``args.save_path``;
    makes the model directory."""
    args.score_save_path = os.path.join(args.save_path, "score.txt")
    args.model_save_path = os.path.join(args.save_path, "model")
    os.makedirs(args.model_save_path, exist_ok=True)
    return args
