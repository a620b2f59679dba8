"""Train CLI of the port (counterpart of the JAX package's ``train.py``).

    python -m ser_tpu_torch.train --synthetic [--epoch 80] [--batch_size 80]
    python -m ser_tpu_torch.train --feature_path /path/to/features/
    python -m ser_tpu_torch.train --dataset MELD --n_classes 7 \\
        --feature_path /path/to/features/
    python -m ser_tpu_torch.train --synthetic --save_state --resume latest
    python -m ser_tpu_torch.train --eval True --initial_model CKPT.npz ...
    python -m ser_tpu_torch.train --synthetic --encoder_attention muse \
        --infonce 0.1 --debug_nans
    python -m ser_tpu_torch.train --synthetic --compute_dtype bf16
    torchrun --nproc_per_node=N -m ser_tpu_torch.train --synthetic --dp
    torchrun --nproc_per_node=N -m ser_tpu_torch.train --synthetic --tp T

The flags are ``train.py``'s, plus ``--device`` (default ``cuda``; without
CUDA it raises unless given ``--device cpu``). The epoch loop is the same:
train, then every ``--test_step`` epochs save ``model/model_%04d.model``
(the JAX package's ``.npz``), eval on the test split (``res.csv``) and append
a line to ``score.txt`` with the best F1 so far; at the end the fusion
weights of each eval go to ``parameters.csv`` in the working directory.
``--eval True`` writes ``score.txt``'s header, as a training run does, and
evaluates ``--initial_model`` on the test split.
With ``--save_state`` every such epoch also writes ``model/last.state``;
``--resume PATH`` (or ``latest``: that file when it exists) continues from
one as if the run had never stopped: the same parameters, Adam state,
generator, shuffles and F1 history. ``--encoder_attention`` swaps the
encoders' MHA for a zoo op, ``--infonce W`` adds W times the InfoNCE term to
the loss of the models with feature outputs, and ``--debug_nans`` raises
``FloatingPointError`` at the first NaN of a train step
(``utils.profiling``). ``--compute_dtype bf16`` trains in the JAX package's
mixed precision (``ModelTrainer``'s ``compute_dtype``). ``--dp`` under
``torchrun`` (one process a card; ``--device cpu`` processes over gloo)
trains data parallel: each process loads its rows of every global batch,
the batch size must divide over the processes, and only rank 0 writes
``score.txt``, the checkpoints, ``res.csv``, ``parameters.csv`` and
``--export_torch``; a single process prints that it runs single, as
``train.py`` does. ``--tp T`` under ``torchrun`` with N processes trains on
the (N / T, T) grid of ``parallel/tp.py``: each process stores its shard
of the weights and Adam's state by the JAX package's rule, the N / T dp
rows each load their rows of every global batch, and only the world's rank
0 writes; T must divide N (one process included) and N / T the batch size,
which ``train.py``'s messages say.
"""

from __future__ import annotations

import argparse
import csv
import os
import sys
import tempfile
import time
from collections import defaultdict

import numpy as np
import torch

from ser_tpu_torch.data.loaders import PrefetchLoader, get_loaders
from ser_tpu_torch.data.synthetic import generate_iemocap_pickles
from ser_tpu_torch.device import resolve_device
from ser_tpu_torch.models.registry import get_model_spec
from ser_tpu_torch.ops.encoder_attention import check_kind
from ser_tpu_torch.parallel import initialize_distributed, world
from ser_tpu_torch.train.trainer import ModelTrainer
from ser_tpu_torch.utils import profiling
from ser_tpu_torch.utils.paths import init_args
from ser_tpu_torch.utils.seeding import seed_everything

def check_supported(args) -> None:
    """Raise on an unknown model (``KeyError`` listing the available ones)
    or an unknown ``--encoder_attention`` (``ValueError``)."""
    get_model_spec(args.model)
    check_kind(args.encoder_attention)


def write_parameters_csv(path, columns: dict) -> None:
    """One column a fusion weight, one row an eval, as pandas' ``to_csv``
    writes floats and lists of floats (softmax(p) of nsps and no_en)."""
    names = list(columns)
    cell = lambda v: (repr(float(v)) if np.ndim(v) == 0  # noqa: E731
                      else str([float(x) for x in v]))
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(names)
        for row in zip(*(columns[n] for n in names)):
            w.writerow([cell(v) for v in row])


def _parallel(args) -> dict:
    """``--tp`` above 1, or ``--dp``, in the process group joined: check
    the layout with ``train.py``'s messages and return the loaders' process
    arguments. ``--tp T`` over N processes is the (N / T, T) grid: the loaders
    take the dp index and count (``parallel/tp.py``)."""
    rank, n = world()
    if args.tp > 1:
        if n % args.tp:
            raise SystemExit(f"--tp {args.tp} does not divide {n} devices")
        n_dp = n // args.tp
        if args.batch_size % n_dp:
            raise SystemExit(f"--tp {args.tp} needs batch_size divisible by {n_dp} "
                             "data-parallel ways")
        if n_dp > 1:
            print(f"process {rank}/{n}: loading {args.batch_size // n_dp} of "
                  f"{args.batch_size} dialogues per batch")
        print(f"2-D mesh: dp={n_dp} x tp={args.tp}")
        return dict(process_index=rank // args.tp, process_count=n_dp) if n_dp > 1 else {}
    if n == 1:
        print("--dp requested but only one device present; running single")
        args.dp = False
        return {}
    if args.batch_size % n:
        raise SystemExit(f"--dp needs batch_size divisible by {n} devices")
    print(f"process {rank}/{n}: loading {args.batch_size // n} of "
          f"{args.batch_size} dialogues per batch")
    print(f"Data-parallel mesh over {n} devices")
    return dict(process_index=rank, process_count=n)


def main(args):
    check_supported(args)
    resolve_device(args.device)  # before any file is written
    parallel = args.tp > 1 or args.dp
    # --dp and --tp join the process group torchrun describes, as train.py
    # joins its processes
    made_group = parallel and not torch.distributed.is_initialized()
    if parallel:
        args.device = str(initialize_distributed(args.device))
    made_group = made_group and torch.distributed.is_initialized()
    try:
        _main(args, _parallel(args) if parallel else {})
    finally:
        if made_group:
            torch.distributed.destroy_process_group()


def _main(args, proc):
    seed_everything(args.seed)
    init_args(args)
    if args.encoder_attention != "mha":
        print(f"Encoder self-attention: {args.encoder_attention} "
              "(attention-zoo surface)")
    use_frontend = args.audio_frontend not in (None, "", "none")
    tmp = None
    if args.synthetic:
        tmp = tempfile.TemporaryDirectory(prefix="ser_tpu_torch_synth_")
        args.feature_path = generate_iemocap_pickles(
            tmp.name, seed=args.seed, with_wav=use_frontend)
    checks_were_on = profiling.nan_checks_enabled()
    if args.debug_nans:
        profiling.enable_nan_checks(True)
    try:
        _run(args, use_frontend, proc)
    finally:
        # an in-process caller gets its own setting back
        profiling.enable_nan_checks(checks_were_on)
        if tmp is not None:
            tmp.cleanup()


def _resolve_resume(resume, model_save_path):
    """``latest`` -> ``model_save_path/last.state`` when it exists, else ''
    (a fresh start); any other value is the path itself."""
    if resume != "latest":
        return resume
    path = model_save_path + "/last.state"
    if not os.path.exists(path):
        print(f"--resume latest: no {path} yet; starting fresh")
        return ""
    return path


def _run(args, use_frontend, proc):
    # only the world's rank 0 writes the files the processes share
    primary = not (args.dp or args.tp > 1) or world()[0] == 0
    train_loader, valid_loader, test_loader = get_loaders(
        args.feature_path, dataset=args.dataset, valid=0.2,
        batch_size=args.batch_size, n_classes=args.n_classes, seed=args.seed,
        roberta_path=args.roberta_path,
        wav_path="auto" if use_frontend else None, **proc)
    if args.num_workers > 0:
        train_loader = PrefetchLoader(train_loader)
        test_loader = PrefetchLoader(test_loader)
    # the header goes out before --eval returns, as in train.py
    with (open(args.score_save_path, "a+") if primary
          else open(os.devnull, "w")) as score_file:
        score_file.write(f"Model: {args.model} \nDataset : {args.dataset}\n"
                         + "-" * 20 + "\n")
        if args.eval:
            trainer = ModelTrainer(**vars(args))
            print("Model %s loaded from previous state!" % args.initial_model)
            trainer.load_parameters(args.initial_model, torch_format=args.torch_format)
            if args.export_torch:  # every process calls it; rank 0 writes
                trainer.export_parameters_torch(args.export_torch)
                print(f"Exported reference-format checkpoint: {args.export_torch}")
            acc, fscore, _ = trainer.eval_network(test_loader)
            print(f"Acc {acc:.2f}, Fscore {fscore:.2f}")
            return

        trainer = ModelTrainer(**vars(args))
        if args.initial_model != "":
            print("Model %s loaded from previous state!" % args.initial_model)
            trainer.load_parameters(args.initial_model, torch_format=args.torch_format)

        start_epoch = 0
        resume_path = _resolve_resume(args.resume, args.model_save_path)
        if resume_path:
            start_epoch = trainer.load_train_state(resume_path)
            # the loaders' generators start from their seeds: draw the shuffles
            # of the finished epochs
            train_loader.advance_epochs(start_epoch)
            valid_loader.advance_epochs(start_epoch)
            print(f"Train state {resume_path} resumed at epoch {start_epoch}!")
        fscores = list(trainer.history.get("fscores", []))
        w_dic = defaultdict(list, {k[len("fusion/"):]: list(v)
                                   for k, v in trainer.history.items()
                                   if k.startswith("fusion/")})
        for epoch in range(start_epoch + 1, args.epoch + 1):
            print("-" * 10, f"epoch {epoch} training", "-" * 10)
            lr, loss = trainer.train_network(epoch, train_loader)
            if epoch % args.test_step:
                continue
            # every process calls it (under --tp it gathers); rank 0 writes
            trainer.save_parameters(args.model_save_path + "/model_%04d.model" % epoch)
            acc, fscore, _ = trainer.eval_network(test_loader)
            for k, v in trainer.fusion_weights().items():
                w_dic[k].append(v)
            fscores.append(fscore)
            best_ep = (int(np.argmax(np.array(fscores))) + 1) * args.test_step
            line = (f"epoch {epoch}, Loss {loss:.2f}, Lr {lr:.6f}, "
                    f"Acc {acc:.2f}, Fscore {fscore:.2f}, "
                    f"Best Fscore: {max(fscores):.2f} [{best_ep}epoch]")
            print(time.strftime("%Y-%m-%d %H:%M:%S"), line)
            score_file.write(time.strftime("%Y-%m-%d %H:%M:%S") + f" —— {line}\n")
            score_file.flush()
            if args.save_state:  # after the eval, so the F1 history is whole
                trainer.save_train_state(
                    args.model_save_path + "/last.state", epoch,
                    {"fscores": fscores, **{f"fusion/{k}": v for k, v in w_dic.items()}})
        if args.export_torch:
            trainer.export_parameters_torch(args.export_torch)
            print(f"Exported reference-format checkpoint: {args.export_torch}")
        score_file.write("\n")
    if primary:
        write_parameters_csv("parameters.csv", w_dic)


def parser_args(argv=None):
    p = argparse.ArgumentParser(
        description="SpeakerEmotionRecognition train (PyTorch/CUDA port)")
    p.add_argument("--epoch", type=int, default=80)
    p.add_argument("--batch_size", type=int, default=80)
    p.add_argument("--num_workers", type=int, default=2)
    p.add_argument("--test_step", type=int, default=1)
    p.add_argument("--eval", type=bool, default=False)
    p.add_argument("--initial_model", type=str, default="")
    p.add_argument("--lr", type=float, default=0.001)
    p.add_argument("--lr_decay", type=float, default=0.98)
    p.add_argument("--seed", type=int, default=111)
    p.add_argument("--loss", type=str, default="CrossEntropy",
                   help="CrossEntropy / NLL")
    p.add_argument("--feature_path", type=str,
                   default="/home/workspaces/SMM22/features/")
    p.add_argument("--roberta_path", type=str, default=None)
    p.add_argument("--dataset", type=str, default="IEMOCAP")
    p.add_argument("--save_path", type=str, default="exps/MARN1_onlysp")
    p.add_argument("--model", type=str, default="MARN1_onlysp")
    p.add_argument("--n_classes", type=int, default=6)
    p.add_argument("--gpu", type=int, default=0,
                   help="kept for CLI parity; the device is --device")
    p.add_argument("--synthetic", action="store_true",
                   help="generate synthetic IEMOCAP-shaped data")
    p.add_argument("--dp", action="store_true",
                   help="data parallelism over the processes torchrun starts "
                        "(one a card; gloo between --device cpu processes)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor parallelism: the weights and Adam's state sharded "
                        "over T of the processes torchrun starts")
    p.add_argument("--debug_nans", action="store_true",
                   help="raise FloatingPointError at the first NaN of a train step")
    p.add_argument("--save_state", action="store_true",
                   help="also write model/last.state every test_step epochs: "
                        "parameters, Adam state, epoch, generator, F1 history")
    p.add_argument("--resume", type=str, default="",
                   help="a .state file from --save_state, or 'latest' for "
                        "save_path's model/last.state when it exists (a fresh "
                        "start otherwise)")
    p.add_argument("--export_torch", type=str, default="",
                   help="also write the parameters as a reference-layout "
                        "torch state dict")
    p.add_argument("--torch_format", action="store_true",
                   help="--initial_model is a reference torch state dict")
    p.add_argument("--infonce", type=float, default=0.0,
                   help="weight of the InfoNCE term on the modality features "
                        "(models without them print a line and skip it)")
    p.add_argument("--encoder_attention", type=str, default="mha",
                   help="the encoders' self-attention: mha / external / self / "
                        "simplified_self / mobilevit_v2 / muse")
    p.add_argument("--compute_dtype", type=str, default="f32",
                   choices=["f32", "bf16"],
                   help="bf16 = mixed precision: forward and backward in bf16, "
                        "master parameters, Adam state and the loss in f32")
    p.add_argument("--audio_frontend", type=str, default="none",
                   help="none / mfcc: compute the 100-d audio slot on the "
                        "device from raw waveforms")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


if __name__ == "__main__":
    args = parser_args()
    print("Python Version:", sys.version)
    print("PyTorch Version:", torch.__version__)
    print("Device:", args.device)
    print("Model:", args.model)
    print("Dataset", args.dataset)
    print("Save path:", args.save_path)
    st = time.time()
    main(args)
    print(f"training done, total {round(time.time() - st, 2)}s")
