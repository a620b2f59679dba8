"""Batch inference CLI: eval a checkpoint on a split, write res.csv and print
the metrics as JSON (counterpart of the JAX package's ``predict.py`` and of
``ModelTrainer.eval_network``).

    python -m ser_tpu_torch.predict --initial_model CKPT.npz \\
        --feature_path /path/to/features/ [--audio_frontend mfcc]
    python -m ser_tpu_torch.predict --synthetic --audio_frontend mfcc \\
        --initial_model CKPT.npz [--device cpu]
    python -m ser_tpu_torch.predict --dataset MELD --n_classes 7 \\
        --feature_path /path/to/features/ --initial_model CKPT.npz
    python -m ser_tpu_torch.predict --encoder_attention external \\
        --initial_model CKPT.npz ...

The flags are ``predict.py``'s, plus ``--device`` (default ``cuda``; without
CUDA it raises unless given ``--device cpu``). ``--initial_model`` is the
JAX package's ``.npz`` of flat parameter names, or with ``--torch_format`` a
reference torch state dict; either loads tolerantly. ``--synthetic`` writes
IEMOCAP pickles, as the JAX CLI does; for MELD, point ``--feature_path`` at
pickles from ``data.synthetic.generate_meld_pickles``. MELD carries no raw
audio, so with ``--audio_frontend mfcc`` its loader gives ``acouf`` and the
front end is not used. ``--encoder_attention`` must be the kind the
checkpoint was trained with: another one builds other encoder parameters,
and the tolerant loader says each checkpoint name it skips.
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import json
import tempfile

import numpy as np
import torch

from ser_tpu_torch.data.loaders import get_loaders
from ser_tpu_torch.data.synthetic import generate_iemocap_pickles
from ser_tpu_torch.device import resolve_device
from ser_tpu_torch.models.registry import get_model_spec
from ser_tpu_torch.ops.encoder_attention import check_kind
from ser_tpu_torch.parallel import gather_rows
from ser_tpu_torch.serving import Predictor
from ser_tpu_torch.train.checkpoint import load_parameters
from ser_tpu_torch.train.metrics import weighted_accuracy, weighted_f1
from ser_tpu_torch.utils.seeding import seed_everything


def _parser():
    p = argparse.ArgumentParser(
        description="SpeakerEmotionRecognition predict (PyTorch/CUDA port)")
    p.add_argument("--initial_model", type=str, required=True)
    p.add_argument("--model", type=str, default="MARN1_onlysp")
    p.add_argument("--feature_path", type=str,
                   default="/home/workspaces/SMM22/features/")
    p.add_argument("--roberta_path", type=str, default=None)
    p.add_argument("--dataset", type=str, default="IEMOCAP")
    p.add_argument("--n_classes", type=int, default=6)
    p.add_argument("--batch_size", type=int, default=80)
    p.add_argument("--seed", type=int, default=111)
    p.add_argument("--split", type=str, default="test",
                   choices=["test", "valid", "train"])
    p.add_argument("--res_csv", type=str, default="res.csv")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--audio_frontend", type=str, default="none",
                   help="none / mfcc: compute the 100-d audio slot on the "
                        "device from raw waveforms")
    p.add_argument("--torch_format", action="store_true",
                   help="--initial_model is a reference torch state dict")
    p.add_argument("--encoder_attention", type=str, default="mha",
                   help="the kind the checkpoint was trained with (train "
                        "--encoder_attention): it changes the encoder parameters")
    p.add_argument("--device", type=str, default="cuda")
    return p


def _check_servable(args):
    """Raise on an unknown model (``KeyError`` listing the available ones)
    or an unknown ``--encoder_attention`` (``ValueError``)."""
    get_model_spec(args.model)
    check_kind(args.encoder_attention)


def fusion_weights(model: torch.nn.Module) -> dict:
    """The model's learned fusion weights, as the JAX trainer's
    ``fusion_weights`` reports them: the scalars w, v, v1, v2, w1, w2 as
    floats (a longer one as a list), and ``p`` as its softmax, taken in f32
    with numpy; empty for a model with none."""
    params = {name: p.detach().cpu().numpy() for name, p in model.named_parameters()
              if "." not in name}
    out = {}
    for name in ("w", "v", "v1", "v2", "w1", "w2"):
        if name in params:
            arr = params[name].reshape(-1)
            out[name] = float(arr[0]) if arr.size == 1 else arr.tolist()
    if "p" in params:
        e = np.exp(params["p"])
        out["p"] = (e / e.sum()).tolist()
    return out


def _write_columns(path, columns: dict, masks) -> None:
    """Integer columns and then ``masks``, in the text form of pandas'
    ``DataFrame.to_csv(index=False)`` (float32 masks as numpy prints them)."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow([*columns, "masks"])
        for *ints, m in zip(*columns.values(), masks):
            w.writerow([*(int(v) for v in ints), str(np.float32(m))])


def write_res_csv(path, preds, labels, masks) -> None:
    """``preds,labels,masks`` rows."""
    _write_columns(path, {"preds": preds, "labels": labels}, masks)


def write_h_csv(path, preds, labels, masks) -> None:
    """The reference's ``h.csv`` (``model_trainer_n.py:133-135``): the rows
    of ``res.csv`` as ``trues,preds,masks``."""
    _write_columns(path, {"trues": labels, "preds": preds}, masks)


def eval_network(predictor: Predictor, loader, res_csv=None, group=None, legacy_h_csv=None):
    """Predict every batch of ``loader``; write ``res_csv`` (and, where it
    is written, ``legacy_h_csv``: ``write_h_csv``) and return
    ``(weighted accuracy, weighted F1)`` over the unmasked utterances. The
    rows of ``res_csv`` are in the order of the model's outputs, as the
    JAX package writes them (time-major for MARN_AT and MARN_ATV). Under
    data parallelism (batches with ``label_global``) each process predicts
    its rows, the predictions are gathered over the processes of ``group``
    (the world's by default; a tp grid's dp group) in rank order and the
    metrics come from the global labels and mask."""
    rows = predictor.spec.rows
    preds, labels, masks = [], [], []
    for batch in loader:
        # predictions stay on the device until the loop ends
        grid = predictor.predict_batch(batch)[1]
        if "label_global" in batch:
            grid = gather_rows(grid, group)
        preds.append(rows(grid))
        labels.append(rows(np.asarray(batch.get("label_global", batch["label"]))))
        masks.append(rows(np.asarray(batch.get("umask_global", batch["umask"]))))
    if not preds:
        return 0.0, 0.0
    preds = torch.cat(preds).cpu().numpy()
    labels = np.concatenate(labels)
    masks = np.concatenate(masks)
    if res_csv:
        write_res_csv(res_csv, preds, labels, masks)
        if legacy_h_csv:
            write_h_csv(legacy_h_csv, preds, labels, masks)
    return (weighted_accuracy(labels, preds, masks),
            weighted_f1(labels, preds, masks))


def main(argv=None):
    args = _parser().parse_args(argv)
    _check_servable(args)
    device = resolve_device(args.device)
    seed_everything(args.seed)
    use_frontend = args.audio_frontend not in (None, "", "none")
    with contextlib.ExitStack() as stack:
        if args.synthetic:
            args.feature_path = generate_iemocap_pickles(
                stack.enter_context(tempfile.TemporaryDirectory(
                    prefix="ser_tpu_torch_predict_")),
                seed=args.seed, with_wav=use_frontend)
        train_loader, valid_loader, test_loader = get_loaders(
            args.feature_path, dataset=args.dataset, valid=0.2,
            batch_size=args.batch_size, n_classes=args.n_classes,
            seed=args.seed, roberta_path=args.roberta_path,
            wav_path="auto" if use_frontend else None)
        loader = {"test": test_loader, "valid": valid_loader,
                  "train": train_loader}[args.split]
        predictor = Predictor(
            args.model, seed=args.seed, device=device, n_classes=args.n_classes,
            audio_frontend=args.audio_frontend if use_frontend else None,
            encoder_attention=args.encoder_attention)
        load_parameters(predictor.model, args.initial_model,
                        torch_format=args.torch_format)
        acc, f1 = eval_network(predictor, loader, args.res_csv)

    print(json.dumps({
        "model": args.model,
        "split": args.split,
        "n_examples": loader.num_examples(),
        "weighted_accuracy": acc,
        "weighted_f1": f1,
        "fusion_weights": fusion_weights(predictor.model),
        "res_csv": args.res_csv,
    }, indent=2))


if __name__ == "__main__":
    main()
