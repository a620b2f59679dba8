"""ModelTrainer, the train and eval engine (counterpart of
``ser_tpu/train/trainer.py``), with the reference's surface:

- ``train_network(epoch, loader) -> (lr, avg_loss)``;
- ``eval_network(loader) -> (acc, f1, {})``, writing ``res.csv``;
- ``save_parameters`` / tolerant ``load_parameters`` and
  ``export_parameters_torch``;
- ``save_train_state`` / ``load_train_state`` for an exact resume: the
  parameters, Adam's moments and step counts, the epoch and the state of the
  generator every dropout draws from (which also seeds the rank-1
  attention's mask stream);
- Adam with coupled decay 2e-5 and StepLR (``train/optim.py``);
- ``encoder_attention``: the encoders' self-attention kind (``"mha"`` or a
  zoo op, ``ops/encoder_attention.py``), and ``infonce``: the weight of
  the reference's commented-out InfoNCE term, added to the loss of the
  models whose spec has ``feature_outputs``;
- with ``utils.profiling.enable_nan_checks()`` (``--debug_nans``), NaN
  checks on the forward's outputs, the loss and the backward of every train
  step;
- ``compute_dtype`` (``--compute_dtype``): ``"f32"``, or ``"bf16"``, the
  JAX trainer's mixed precision: the master parameters, Adam's state and
  the loss stay f32, and the forward and backward run on bf16 copies of the
  parameters and the float batch arrays, made inside autograd
  (``torch.func.functional_call``), so ``.grad`` lands in f32 on the
  masters; the outputs are widened to f32 before the loss. Not
  ``torch.autocast``, which keeps LayerNorm and the softmaxes in f32 and
  casts only the products: another function than the JAX step. Eval,
  checkpoints and resume stay f32;
- ``dp`` (``--dp``) under a ``torch.distributed`` process group
  (``parallel.initialize_distributed``): data parallelism over dialogues.
  Each process steps on its rows of the global batch (the loader's
  ``process_index``), divides its summed loss by the global mask sum, and
  the gradients and the loss are summed over the processes
  (``parallel.all_reduce_grads``) before Adam, which gives the one-process
  step. Eval gathers the predictions; only rank 0 writes ``res.csv`` and the
  train-state file. Each process draws its dropouts from its own stream,
  seeded from (seed, rank), so with dropout on a step is not the
  one-process step (the JAX package draws one global mask; ROADMAP §C).

The model lives on one device (``cuda`` unless the caller asks for the CPU).
A train step is eager PyTorch: the forward with every dropout drawn from the
trainer's generator on that device, the masked loss (labels and mask in the
order of the model's rows, ``ModelSpec.rows``), backward, and the Adam
update. On the card the per-step rank-1 attention of MARN1_onlysp and the
six variants runs as its CUDA kernel, forward and backward. Eval runs the
model in eval mode through the same ``Predictor`` and loop as ``python -m
ser_tpu_torch.predict``, so on the card MARN1_onlysp launches the recurrence
kernel once a batch.
"""

from __future__ import annotations

import time
from itertools import chain

import numpy as np
import torch

from ser_tpu_torch import parallel
from ser_tpu_torch.predict import eval_network, fusion_weights
from ser_tpu_torch.serving import Predictor
from ser_tpu_torch.train import checkpoint as ckpt
from ser_tpu_torch.train.losses import info_nce, masked_loss
from ser_tpu_torch.train.optim import set_lr, step_lr, torch_adam
from ser_tpu_torch.utils import profiling


COMPUTE_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _widen(out):
    """Every float tensor of the forward's output (a tensor or a tuple or
    list of them, nested) in f32, as the JAX step's ``_cast_floats``."""
    if isinstance(out, (tuple, list)):
        return type(out)(_widen(o) for o in out)
    return out.float() if torch.is_tensor(out) and out.is_floating_point() else out


def stream_seed(seed: int, rank: int) -> int:
    """The dropout generator's seed of process ``rank``: ``seed`` itself for
    rank 0, so one process keeps its stream."""
    if rank == 0:
        return int(seed)
    return int(np.random.SeedSequence([int(seed), int(rank)]).generate_state(1)[0])


class ModelTrainer:
    def __init__(self, device=None, lr=1e-3, test_step=1, lr_decay=0.98,
                 model="MARN1_onlysp", loss="CrossEntropy", n_classes=6,
                 seed=111, weight_decay=2e-5, res_csv_path="res.csv",
                 audio_frontend=None, infonce=0.0, encoder_attention="mha",
                 compute_dtype="f32", dp=False, **kwargs):
        del kwargs  # the CLI passes all of its flags
        if compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(
                f"compute_dtype must be 'f32' or 'bf16', got {compute_dtype!r}")
        self.compute_dtype = COMPUTE_DTYPES[compute_dtype]
        # data parallel under a process group, of any size (one included)
        self.dp = bool(dp) and torch.distributed.is_initialized()
        self.rank, self.world = parallel.world() if self.dp else (0, 1)
        self.predictor = Predictor(model, seed=seed, device=device,
                                   n_classes=n_classes, audio_frontend=audio_frontend,
                                   encoder_attention=encoder_attention)
        self.device = self.predictor.device
        self.model = self.predictor.model
        self.loss_kind = loss
        self.n_classes = n_classes
        self.res_csv_path = res_csv_path
        self.infonce = float(infonce)
        if self.infonce > 0 and not self.predictor.spec.feature_outputs:
            # the JAX trainer's quiet no-op for the models without features
            print(f"[infonce] {model} has no modality-feature outputs; "
                  f"the InfoNCE term is skipped")
        if self.dp:
            parallel.broadcast_params(self.model)
        # every dropout mask of a train step is drawn from this generator
        self.generator = torch.Generator(self.device).manual_seed(
            stream_seed(seed, self.rank))
        n_params = sum(p.numel() for p in self.model.parameters())
        print(time.strftime("%m-%d %H:%M:%S")
              + " Model para number = %.2f" % (n_params / 1024 / 1024))
        self.weight_decay = weight_decay
        self.optimizer = torch_adam(self.model.parameters(), lr, weight_decay)
        self.lr_at = step_lr(lr, lr_decay, test_step)
        self.history = {}  # filled by load_train_state

    def _train_step_impl(self, batch, lr: float) -> torch.Tensor:
        """One optimizer step on a collated numpy batch; returns the loss on
        the device. Gradients are cleared to None first and stay in ``.grad``
        after the step; a parameter the forward never touches has none, and
        Adam skips it."""
        self.model.train()
        spec = self.predictor.spec
        with torch.no_grad():  # the front end's features take no gradient
            x, qmask, umask = self.predictor.batch_inputs(batch, self.compute_dtype)
        # labels and mask in the order of the model's rows (JAX _flat_targets)
        labels = spec.rows(torch.as_tensor(batch["label"], device=self.device))
        self.optimizer.zero_grad(set_to_none=True)
        out = self._forward(x, qmask, umask)
        profiling.check_finite("the forward's outputs",
                               *(out if isinstance(out, tuple) else (out,)))
        logp = spec.extract_logp(out)
        # the global batch's mask sum under data parallelism
        denominator = (float(np.sum(batch["umask_global"]))
                       if "umask_global" in batch else None)
        # MARN1_newz and BiLSTM have 6 outputs whatever n_classes says; only
        # where the widths differ does a label past the outputs add 0, as in
        # the JAX package (ROADMAP §C), and elsewhere it raises. The mask is
        # the batch's f32 one, as in the JAX step
        loss = masked_loss(logp, labels, spec.rows(umask.float()), kind=self.loss_kind,
                           outside_adds_zero=logp.shape[-1] != self.n_classes,
                           denominator=denominator)
        if self.infonce > 0 and spec.feature_outputs:
            loss = loss + self.infonce * self.infonce_term(out, self.dp)
        profiling.check_finite("the loss", loss)
        profiling.backward(loss)
        loss = loss.detach()
        if self.dp:
            (loss,) = parallel.all_reduce_grads(self.model.parameters(), loss)
        set_lr(self.optimizer, lr)
        self.optimizer.step()
        return loss

    def _forward(self, x, qmask, umask):
        """The train forward. In a bf16 step the parameters (and buffers)
        are cast to bf16 inside autograd and the model runs on the casts
        (``functional_call``), the JAX step's ``_cast_floats`` of the params
        in ``loss_fn``; it computes in x's dtype, bf16, or f32 where the
        audio front end's f32 features promote x (the JAX concatenation's
        promotion), and then the casts are widened back to f32. The outputs
        come back in f32."""
        if self.compute_dtype is torch.float32:
            return self.model(x, qmask, umask, generator=self.generator)
        dtype = x.dtype
        tensors = {name: t.to(self.compute_dtype).to(dtype) if t.is_floating_point() else t
                   for name, t in chain(self.model.named_parameters(),
                                        self.model.named_buffers())}
        out = torch.func.functional_call(
            self.model, tensors, (x, qmask.to(dtype), umask.to(dtype)),
            {"generator": self.generator})
        return _widen(out)

    @staticmethod
    def infonce_term(out, data_parallel: bool = False) -> torch.Tensor:
        """The reference's commented formulation (``model_trainer.py:111-115``):
        each dialogue's time-major features ``out[1]``, ``out[2]`` ``[L, B,
        D]`` flattened to ``[B, L·D]``, padded positions included; query and
        positive ``out[1]``, negatives ``out[2]``, unpaired. With
        ``data_parallel`` the negatives are every process's rows
        (``parallel.gather_rows``) and the term is this process's share of
        the global mean, so the processes' terms sum to the global one."""
        b = out[1].shape[1]
        q = out[1].transpose(0, 1).reshape(b, -1)
        neg = out[2].transpose(0, 1).reshape(b, -1)
        if not data_parallel:
            return info_nce(q, q, neg, negative_mode="unpaired")
        negatives = parallel.gather_rows(neg)
        rows = info_nce(q, q, negatives, negative_mode="unpaired", reduction="none")
        return rows.sum() / negatives.shape[0]

    def train_network(self, epoch, loader):
        lr = self.lr_at(epoch)
        losses, mask_sums = [], []
        for batch in loader:
            # the losses stay on the device until the epoch ends: a float()
            # here would wait for every step; a step's loss is the global
            # batch's, weighted by its mask (umask_global under dp)
            losses.append(self._train_step_impl(batch, lr))
            mask_sums.append(float(np.sum(batch.get("umask_global", batch["umask"]))))
        losses = torch.stack(losses).cpu().numpy() if losses else []
        avg_loss = round(float(np.sum([float(l) * m for l, m in zip(losses, mask_sums)])
                               / np.sum(mask_sums)), 4)
        return lr, avg_loss

    def eval_network(self, loader):
        self.model.eval()
        acc, f1 = eval_network(self.predictor, loader,
                               self.res_csv_path if self.rank == 0 else None)
        return acc, f1, {}

    def fusion_weights(self):
        return fusion_weights(self.model)

    def save_parameters(self, path):
        ckpt.save_parameters(self.model, path)

    def load_parameters(self, path, torch_format=False):
        ckpt.load_parameters(self.model, path, torch_format=torch_format)
        # the reference checkpoints no optimizer state: Adam starts anew
        self.optimizer = torch_adam(self.model.parameters(),
                                    self.optimizer.param_groups[0]["lr"],
                                    self.weight_decay)

    def save_train_state(self, path, epoch, history=None):
        """Everything a resumed run needs to continue as if never stopped:
        the parameters, Adam's state, ``epoch``, the generator's state and
        ``history`` (name -> list of floats the caller keeps across epochs,
        such as the train CLI's F1 scores), as ``extra/history/<name>``.
        Under data parallelism every process calls it: rank 0 gathers each
        process's generator state (``[world, n]``) and writes the file."""
        state = self.generator.get_state()
        if self.world > 1:
            state = parallel.gather_rows(state[None].to(self.device)).cpu()
        if self.rank != 0:
            return
        extra = {"epoch": int(epoch), "generator": state.numpy()}
        if self.world > 1:  # a one-process file has no such key
            extra["world_size"] = self.world
        for name, values in (history or {}).items():
            extra[f"history/{name}"] = np.asarray(values, dtype=np.float64)
        ckpt.save_train_state(path, self.model, self.optimizer, extra)

    def load_train_state(self, path):
        """Restore a ``save_train_state`` file; returns the saved epoch and
        leaves the saved history in ``self.history``. Each process restores
        its own generator state; a file written by another number of
        processes raises ``ValueError``."""
        with np.load(path) as z:  # before anything is restored
            saved = int(z["extra/world_size"]) if "extra/world_size" in z.files else 1
        if saved != self.world:
            raise ValueError(f"train-state file {path} was written by {saved} "
                             f"process(es); this run has {self.world}")
        extra = ckpt.load_train_state(path, self.model, self.optimizer)
        missing = sorted({"epoch", "generator"} - set(extra))
        if missing:
            raise ValueError(f"train-state file {path} lacks extra/{missing}")
        state = extra["generator"]
        self.generator.set_state(torch.from_numpy(state[self.rank] if state.ndim == 2
                                                  else state))
        self.history = {k[len("history/"):]: v.tolist() for k, v in extra.items()
                        if k.startswith("history/")}
        return int(extra["epoch"])

    def export_parameters_torch(self, path):
        """``torch.save`` of the state dict, whose keys are the reference's:
        the reference stack and ``load_parameters(torch_format=True)`` read it."""
        torch.save({k: v.detach().cpu() for k, v in self.model.state_dict().items()},
                   path)
