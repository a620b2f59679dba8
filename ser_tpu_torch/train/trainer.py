"""ModelTrainer, the train and eval engine (counterpart of
``ser_tpu/train/trainer.py``), with the reference's surface:

- ``train_network(epoch, loader) -> (lr, avg_loss)``;
- ``eval_network(loader) -> (acc, f1, {})``, writing ``res.csv`` and, with
  ``legacy_h_csv_path``, the reference's ``h.csv`` beside it (the same rows
  as ``trues,preds,masks``, ``model_trainer_n.py``'s layout);
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
  one-process step (the JAX package draws one global mask; ROADMAP §C);
- ``tp`` (``--tp``) under a process group of ``n_dp * tp`` processes:
  the (dp, tp) grid of ``parallel/tp.py``. Each process stores its shard of
  every parameter the JAX rule shards (``parallel.shard_dims``), so Adam's
  moments are shards too; the train forward runs the one-process model on
  the whole weights, gathered inside autograd (``parallel.gather_shards``;
  cast to bf16 after the gather under ``compute_dtype="bf16"``), and each
  process keeps its slice of each whole gradient. The dp index takes the
  place of the rank above (rows, dropout stream, the gradients' and the
  InfoNCE negatives' group); the processes of a tp group so draw the same
  masks, and at ``n_dp`` 1 a step is the one-process step. Eval,
  ``fusion_weights`` and the files run on the gathered whole weights
  (``parallel.whole_parameters``), so every tp process must call them; the
  files have the one-process layout and keys, and only the world's rank 0
  writes them.

The model lives on one device (``cuda`` unless the caller asks for the CPU).
A train step is the forward with every dropout drawn from the trainer's
generator on that device, the masked loss (labels and mask in the order of
the model's rows, ``ModelSpec.rows``), backward, and the Adam update. On the
card the per-step rank-1 attention of MARN1_onlysp and the six variants runs
as its CUDA kernel, forward and backward. Where ``step_graph.engages`` holds
(the card, one process, f32, no NaN checks, no InfoNCE, the encoders' MHA,
a model marked ``train_graph_safe``: MARN1_onlysp and the variants) the
whole step is a CUDA graph of its key, shape and dropout rates
(``train/step_graph.py``): the batch is copied into the graph's static
inputs, the graph replayed, and its loss cloned; a key's first step runs
eagerly, then is captured. Adam is then ``capturable``, with its learning
rate a tensor on the card that ``set_lr`` writes in place. The graphs are
dropped when the optimizer is replaced or loads a state, and when a train
state is loaded. Every other case runs the step eagerly. Eval runs the
model in eval mode through the same ``Predictor`` and loop as ``python -m
ser_tpu_torch.predict``, so on the card MARN1_onlysp launches the recurrence
kernel once a batch.
"""

from __future__ import annotations

import contextlib
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
from ser_tpu_torch.train.step_graph import StepGraphs, engages, graph_key
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
                 compute_dtype="f32", dp=False, tp=1, legacy_h_csv_path=None, **kwargs):
        del kwargs  # the CLI passes all of its flags
        if compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(
                f"compute_dtype must be 'f32' or 'bf16', got {compute_dtype!r}")
        self.compute_dtype = COMPUTE_DTYPES[compute_dtype]
        self.grid = None
        if tp > 1:  # the (dp, tp) grid over every process of the group
            n = parallel.world()[1]
            if n % tp:
                raise ValueError(f"tp={tp} does not divide {n} processes")
            self.grid = parallel.make_grid(n // tp, tp)
        # data parallel under a process group, of any size (one included);
        # rank and world are the dp index and count
        self.dp = (bool(dp) and torch.distributed.is_initialized()) or self.grid is not None
        if self.grid is not None:
            self.rank, self.world = self.grid.dp_index, self.grid.n_dp
        else:
            self.rank, self.world = parallel.world() if self.dp else (0, 1)
        self.dp_group = None if self.grid is None else self.grid.dp_group
        # only the world's rank 0 writes what the processes share
        self.primary = not self.dp or parallel.world()[0] == 0
        self.predictor = Predictor(model, seed=seed, device=device,
                                   n_classes=n_classes, audio_frontend=audio_frontend,
                                   encoder_attention=encoder_attention)
        self.device = self.predictor.device
        self.model = self.predictor.model
        self.loss_kind = loss
        self.n_classes = n_classes
        self.res_csv_path = res_csv_path
        self.legacy_h_csv_path = legacy_h_csv_path
        self.infonce = float(infonce)
        if self.infonce > 0 and not self.predictor.spec.feature_outputs:
            # the JAX trainer's quiet no-op for the models without features
            print(f"[infonce] {model} has no modality-feature outputs; "
                  f"the InfoNCE term is skipped")
        if self.dp:
            parallel.broadcast_params(self.model)
        n_params = sum(p.numel() for p in self.model.parameters())
        # parameter name -> the dim its shards split, for the sharded ones
        self.shards = {}
        if self.grid is not None:
            self.shards = {n: d for n, d in parallel.shard_dims(self.model, tp).items()
                           if d is not None}
            parallel.shard_model_(self.model, self.shards, self.grid)
        # every dropout mask of a train step is drawn from this generator
        self.generator = torch.Generator(self.device).manual_seed(
            stream_seed(seed, self.rank))
        print(time.strftime("%m-%d %H:%M:%S")
              + " Model para number = %.2f" % (n_params / 1024 / 1024))
        self.weight_decay = weight_decay
        # the steps' CUDA graphs, used where engages() holds at construction
        # and at each step (the NaN checks can be turned on in between)
        self.graphs = StepGraphs(self.device, self.generator)
        self.graphed = engages(self.device, self._layout()[0], self.compute_dtype,
                               self.infonce, encoder_attention, self.model)
        self.optimizer = self._adam(lr)
        self.lr_at = step_lr(lr, lr_decay, test_step)
        self.history = {}  # filled by load_train_state

    def _adam(self, lr):
        """A new optimizer (capturable where the steps are graphed); the
        graphs, which captured the old one, are dropped, and so are they
        whenever it loads a state."""
        self.graphs.clear()
        optimizer = torch_adam(self.model.parameters(), lr, self.weight_decay,
                               tp_group=None if self.grid is None else self.grid.tp_group,
                               capturable=self.graphed)
        graphs = self.graphs  # not self: the hook keeps no trainer alive
        optimizer.register_load_state_dict_post_hook(lambda _: graphs.clear())
        return optimizer

    def _train_step_impl(self, batch, lr: float) -> torch.Tensor:
        """One optimizer step on a collated numpy batch; returns the loss on
        the device. Gradients are cleared to None first and stay in ``.grad``
        after the step; a parameter the forward never touches has none, and
        Adam skips it."""
        with profiling.annotate("ser#train.step"):
            self.model.train()
            if (self.graphed and not profiling.nan_checks_enabled()
                    and "umask_global" not in batch):
                return self._graph_step(batch, lr)
            with torch.no_grad():  # the front end's features take no gradient
                x, qmask, umask = self.predictor.batch_inputs(batch, self.compute_dtype)
            # labels and mask in the order of the model's rows (JAX _flat_targets)
            labels = self.predictor.spec.rows(torch.as_tensor(batch["label"], device=self.device))
            # the global batch's mask sum under data parallelism
            denominator = (float(np.sum(batch["umask_global"]))
                           if "umask_global" in batch else None)
            loss = self._loss_and_grads(x, qmask, umask, labels, denominator)
            set_lr(self.optimizer, lr)
            self.optimizer.step()
            return loss

    def _graph_step(self, batch, lr: float) -> torch.Tensor:
        """The step as its key's CUDA graph: the batch copied into the static
        inputs (one ``copy_`` each, inside ``ser#inputs``), then a replay, or
        at the key's first sight an eager step and the capture."""
        with profiling.annotate("ser#inputs"), torch.no_grad():
            x, qmask, umask = self.predictor.device_inputs(batch, self.compute_dtype)
            fresh = dict(x=x, qmask=qmask, umask=umask, label=torch.as_tensor(batch["label"]))
            static = self.graphs.inputs(fresh)
            for name, t in fresh.items():
                static[name].copy_(t)
        set_lr(self.optimizer, lr)  # the lr tensor, outside the graph

        def run():
            loss = self._loss_and_grads(static["x"], static["qmask"], static["umask"],
                                        self.predictor.spec.rows(static["label"]))
            self.optimizer.step()
            return loss

        return self.graphs.step(graph_key(x.shape, qmask.shape[-1], self.model),
                                list(self.model.parameters()), run)

    def _loss_and_grads(self, x, qmask, umask, labels, denominator=None) -> torch.Tensor:
        """The forward, the masked loss (with ``denominator`` in place of the
        mask's sum) and the backward into freshly cleared ``.grad``, summed
        over the dp processes; returns the loss, detached."""
        spec = self.predictor.spec
        self.optimizer.zero_grad(set_to_none=True)
        with profiling.annotate("ser#forward"):
            out = self._forward(x, qmask, umask)
        profiling.check_finite("the forward's outputs",
                               *(out if isinstance(out, tuple) else (out,)))
        logp = spec.extract_logp(out)
        # MARN1_newz and BiLSTM have 6 outputs whatever n_classes says; only
        # where the widths differ does a label past the outputs add 0, as in
        # the JAX package (ROADMAP §C), and elsewhere it raises. The mask is
        # the batch's f32 one, as in the JAX step
        loss = masked_loss(logp, labels, spec.rows(umask.float()), kind=self.loss_kind,
                           outside_adds_zero=logp.shape[-1] != self.n_classes,
                           denominator=denominator)
        if self.infonce > 0 and spec.feature_outputs:
            loss = loss + self.infonce * self.infonce_term(out, self.world > 1, self.dp_group)
        profiling.check_finite("the loss", loss)
        with profiling.annotate("ser#backward"):
            profiling.backward(loss)
        loss = loss.detach()
        if self.world > 1:
            (loss,) = parallel.all_reduce_grads(self.model.parameters(), loss,
                                                group=self.dp_group)
        return loss

    def _forward(self, x, qmask, umask):
        """The train forward. Under ``tp`` the model runs on the whole
        parameters, gathered from the shards inside autograd
        (``functional_call``). In a bf16 step the parameters (and buffers),
        whole, are cast to bf16 inside autograd and the model runs on the
        casts, the JAX step's ``_cast_floats`` of the params in ``loss_fn``;
        it computes in x's dtype, bf16, or f32 where the audio front end's
        f32 features promote x (the JAX concatenation's promotion), and then
        the casts are widened back to f32. The outputs come back in f32."""
        if self.compute_dtype is torch.float32 and self.grid is None:
            return self.model(x, qmask, umask, generator=self.generator)
        tensors = dict(chain(self.model.named_parameters(), self.model.named_buffers()))
        if self.grid is not None:
            names = list(self.shards)
            tensors.update(zip(names, parallel.gather_shards(
                [tensors[n] for n in names], [self.shards[n] for n in names], self.grid)))
        if self.compute_dtype is torch.float32:
            return torch.func.functional_call(self.model, tensors, (x, qmask, umask),
                                              {"generator": self.generator})
        dtype = x.dtype
        tensors = {name: t.to(self.compute_dtype).to(dtype) if t.is_floating_point() else t
                   for name, t in tensors.items()}
        out = torch.func.functional_call(
            self.model, tensors, (x, qmask.to(dtype), umask.to(dtype)),
            {"generator": self.generator})
        return _widen(out)

    @staticmethod
    def infonce_term(out, data_parallel: bool = False, group=None) -> torch.Tensor:
        """The reference's commented formulation (``model_trainer.py:111-115``):
        each dialogue's time-major features ``out[1]``, ``out[2]`` ``[L, B,
        D]`` flattened to ``[B, L·D]``, padded positions included; query and
        positive ``out[1]``, negatives ``out[2]``, unpaired. With
        ``data_parallel`` the negatives are every process's rows of
        ``group`` (``parallel.gather_rows``; the world's by default, a tp
        grid's dp group) and the term is this process's share of the global
        mean, so the processes' terms sum to the global one."""
        b = out[1].shape[1]
        q = out[1].transpose(0, 1).reshape(b, -1)
        neg = out[2].transpose(0, 1).reshape(b, -1)
        if not data_parallel:
            return info_nce(q, q, neg, negative_mode="unpaired")
        negatives = parallel.gather_rows(neg, group)
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

    def whole_parameters(self, reshard=False):
        """A context in which the model holds its whole parameters, and with
        ``reshard`` what is written into them reaches the shards (a no-op
        without ``tp``; ``parallel.whole_parameters``). Every tp process
        must enter it."""
        if self.grid is None:
            return contextlib.nullcontext()
        return parallel.whole_parameters(self.model, self.shards, self.grid, reshard)

    def eval_network(self, loader):
        self.model.eval()
        with self.whole_parameters():
            acc, f1 = eval_network(self.predictor, loader,
                                   self.res_csv_path if self.primary else None,
                                   group=self.dp_group, legacy_h_csv=self.legacy_h_csv_path)
        return acc, f1, {}

    def fusion_weights(self):
        with self.whole_parameters():
            return fusion_weights(self.model)

    def save_parameters(self, path):
        """Every process calls it; the world's rank 0 writes."""
        with self.whole_parameters():
            if self.primary:
                ckpt.save_parameters(self.model, path)

    def load_parameters(self, path, torch_format=False):
        with self.whole_parameters(reshard=True):
            ckpt.load_parameters(self.model, path, torch_format=torch_format)
        # the reference checkpoints no optimizer state: Adam starts anew
        self.optimizer = self._adam(self.optimizer.param_groups[0]["lr"])

    def _layout(self) -> tuple[int, int]:
        """``(processes, tp)`` of this run, which a train-state file records
        as ``world_size`` and ``tp`` where each is above 1."""
        n_tp = 1 if self.grid is None else self.grid.n_tp
        return self.world * n_tp, n_tp

    def _whole_train_state(self) -> tuple[dict, dict]:
        """``(parameters, Adam states)`` by key, whole: under ``tp`` the
        shards of both gathered (every tp process must call it)."""
        named = dict(self.model.named_parameters())
        states = {n: self.optimizer.state.get(p) for n, p in named.items()}
        if self.grid is None:
            return named, states
        # the live set (Adam has state) is the same on every tp process
        parts = [(n, None) for n in self.shards] + [
            (n, leaf) for n in self.shards if states[n] for leaf in ("exp_avg", "exp_avg_sq")]
        with torch.no_grad():
            wholes = parallel.gather_shards(
                [named[n] if leaf is None else states[n][leaf] for n, leaf in parts],
                [self.shards[n] for n, _ in parts], self.grid)
        states = {n: dict(s) if s else s for n, s in states.items()}
        for (n, leaf), whole in zip(parts, wholes):
            if leaf is None:
                named[n] = whole
            else:
                states[n][leaf] = whole
        return named, states

    def save_train_state(self, path, epoch, history=None):
        """Everything a resumed run needs to continue as if never stopped:
        the parameters, Adam's state, ``epoch``, the generator's state and
        ``history`` (name -> list of floats the caller keeps across epochs,
        such as the train CLI's F1 scores), as ``extra/history/<name>``.
        Under data or tensor parallelism every process calls it: the dp
        processes' generator states are gathered (``[dp count, n]``), the
        shards made whole, and the world's rank 0 writes the one-process
        layout with the processes' (``_layout``)."""
        state = self.generator.get_state()
        if self.world > 1:
            state = parallel.gather_rows(state[None].to(self.device), self.dp_group).cpu()
        params, states = self._whole_train_state()
        if not self.primary:
            return
        extra = {"epoch": int(epoch), "generator": state.numpy()}
        for key, value in zip(("world_size", "tp"), self._layout()):
            if value > 1:  # a one-process file has no such key
                extra[key] = value
        for name, values in (history or {}).items():
            extra[f"history/{name}"] = np.asarray(values, dtype=np.float64)
        ckpt.save_train_state(path, params, states, extra)

    def load_train_state(self, path):
        """Restore a ``save_train_state`` file; returns the saved epoch and
        leaves the saved history in ``self.history``. Each dp process
        restores its own generator state, and under ``tp`` each process its
        shards; a file written by another number of processes, or at
        another ``tp``, raises ``ValueError``."""
        with np.load(path) as z:  # before anything is restored
            saved_n, saved_tp = (int(z[f"extra/{k}"]) if f"extra/{k}" in z.files else 1
                                 for k in ("world_size", "tp"))
        n, n_tp = self._layout()
        if saved_n != n:
            raise ValueError(f"train-state file {path} was written by {saved_n} "
                             f"process(es); this run has {n}")
        if saved_tp != n_tp:
            raise ValueError(f"train-state file {path} was written at tp={saved_tp}; "
                             f"this run has tp={n_tp}")
        named = dict(self.model.named_parameters())
        shapes = {n: tuple(p.shape) for n, p in named.items()}
        for n, d in self.shards.items():  # the file holds whole leaves
            shapes[n] = shapes[n][:d] + (shapes[n][d] * self.grid.n_tp,) + shapes[n][d + 1:]
        params, states, extra = ckpt.load_train_state(path, shapes)
        missing = sorted({"epoch", "generator"} - set(extra))
        if missing:
            raise ValueError(f"train-state file {path} lacks extra/{missing}")
        for n, d in self.shards.items():
            params[n] = parallel.local_shard(params[n], d, self.grid)
            for leaf in ("exp_avg", "exp_avg_sq") if states[n] else ():
                states[n][leaf] = parallel.local_shard(states[n][leaf], d, self.grid)
        with torch.no_grad():
            for n, p in named.items():
                p.copy_(params[n])
        index = {n: i for i, n in enumerate(named)}
        self.optimizer.load_state_dict({
            "state": {index[n]: s for n, s in states.items() if s},
            "param_groups": self.optimizer.state_dict()["param_groups"]})
        state = extra["generator"]
        self.generator.set_state(torch.from_numpy(state[self.rank] if state.ndim == 2
                                                  else state))
        self.graphs.clear()  # what they captured was restored under them
        self.history = {k[len("history/"):]: v.tolist() for k, v in extra.items()
                        if k.startswith("history/")}
        return int(extra["epoch"])

    def export_parameters_torch(self, path):
        """``torch.save`` of the state dict, whose keys are the reference's:
        the reference stack and ``load_parameters(torch_format=True)`` read it.
        Every process calls it; the world's rank 0 writes."""
        with self.whole_parameters():
            if self.primary:
                torch.save({k: v.detach().cpu() for k, v in self.model.state_dict().items()},
                           path)
