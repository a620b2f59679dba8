"""The train-epochs driver: ``ModelTrainer.train_network(epoch, batches)``
over whole epochs of a synthetic train split, closed loop.

Set-up: the split and a few shuffled epochs of collated batches (the
traffic's ``shuffles``, cycled through the window), the weights from the
seed on the card, the trainer with those weights loaded strictly, and a
warm-up step at each (L, B) that the window's epochs hold. The window runs
whole epochs until ``seconds`` have passed; it ends at the synchronise
that ends its last epoch (``train_network`` fetches the epoch's losses). A
traced run then profiles ``trace_epochs`` more epochs. Then the same
trainer, warmed and timed, takes the check steps: its model gets the
seed's weights back (``load_state_dict``), its optimizer the state it had
before its first step, every dropout rate of the model goes to 0 (the
masks come from the trainer's generator in an order that the program may
change, so no reference could follow them), and ``check_steps`` calls of
``train_network`` each take one batch of the shape of the window's first
batches, on dialogues that no other step sees. Last, with the trainer
freed, the reference repeats the check steps in float64 from the same
weights and batches (``compare``).
"""

from __future__ import annotations

import copy
import gc
import time

import numpy as np

from benchmark import compare, generate
from benchmark.cell import Outcome, Readings, rate_by_thirds
from benchmark.reference import common
from benchmark.trace import profile_slice
from benchmark.weights import make_weights


def sub_seed(seed: int, k: int) -> int:
    """A 32-bit seed for the run's ``k``-th use of ``seed``."""
    return int(np.random.SeedSequence([int(seed), k]).generate_state(1)[0])


def dropout_off(model) -> list:
    """Every dropout rate of the program's model set to 0 (its ``Dropout``
    modules' ``p`` and the models' float ``dropout_rate`` and
    ``attn_dropout``); returns what ``restore`` needs."""
    saved = []
    for m in model.modules():
        if type(m).__name__ == "Dropout" and isinstance(getattr(m, "p", None), float):
            saved.append((m, "p", m.p))
        for attr in ("dropout_rate", "attn_dropout"):
            if isinstance(getattr(m, attr, None), float):
                saved.append((m, attr, getattr(m, attr)))
    for m, attr, _ in saved:
        setattr(m, attr, 0.0)
    return saved


def restore(saved) -> None:
    for m, attr, value in saved:
        setattr(m, attr, value)


def leaf_norms(tensors: dict) -> dict:
    """name -> float64 norm; 0 for a missing tensor."""
    return {n: (0.0 if t is None else float(t.double().norm())) for n, t in tensors.items()}


def data(cell, seed: int):
    """``(epochs, check batches, utterances an epoch)`` of the run's seed.
    The shuffles are the length seed's, the same for every seed, which
    picks the one the cycle starts at and draws the features; the check
    batches repeat the shapes of the cycle's first ``check_steps`` batches
    on dialogues of their own."""
    cfg, tr = cell.config, cell.traffic
    rng = np.random.default_rng([int(seed), 1])
    lengths = generate.split_lengths(tr)
    groups = generate.shuffles(len(lengths), tr["batch_size"], tr["shuffles"],
                               np.random.default_rng([tr["length_seed"], 1]))
    first = int(rng.integers(len(groups)))
    groups = groups[first:] + groups[:first]
    split = generate.make_split(lengths, cfg, rng)
    epochs = generate.epochs(split, groups)
    steps = [idx for epoch in groups for idx in epoch][:tr["check_steps"]]
    check_split = generate.make_split(np.concatenate([lengths[idx] for idx in steps]), cfg, rng)
    offsets = np.cumsum([0] + [len(idx) for idx in steps])
    check = [generate.collate(check_split, np.arange(a, b))
             for a, b in zip(offsets[:-1], offsets[1:])]
    return epochs, check, split.utterances


def check_steps(trainer, weights, optimizer_start, batches):
    """The check steps on ``trainer`` from ``weights`` and the optimizer's
    state ``optimizer_start``, every dropout rate at 0: ``(losses, first
    gradient norms as Adam got them, change norms after the steps)``."""
    trainer.model.load_state_dict(weights, strict=True)
    trainer.optimizer.load_state_dict(optimizer_start)
    named = dict(trainer.model.named_parameters())
    saved = dropout_off(trainer.model)
    losses, first = [], None
    for batch in batches:
        losses.append(trainer.train_network(1, [batch])[1])
        if first is None:
            moments = {n: trainer.optimizer.state.get(p, {}).get("exp_avg")
                       for n, p in named.items()}
            first = leaf_norms({n: None if m is None else m / (1 - common.BETAS[0])
                                for n, m in moments.items()})
    restore(saved)
    change = leaf_norms({n: p.detach() - weights[n] for n, p in named.items()})
    return losses, first, change


def reference_steps(torch, cell, weights, batches, device):
    """The reference's check steps in float64 from ``weights``: ``(losses,
    first gradient norms as Adam gets them, raw gradient norms a step,
    change norms after the steps)``."""
    tr = cell.traffic
    params = {n: w.detach().to(device, torch.float64) for n, w in weights.items()}
    start = {n: p.clone() for n, p in params.items()}
    state, losses, raw_norms, first = {}, [], [], None
    for batch in batches:
        b = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
        x = common.reference_input(cell, b)
        live = {n: p.detach().requires_grad_() for n, p in params.items()}
        logp = cell.reference.forward(live, x, b["qmask"].double(), b["umask"].double())
        loss = common.masked_loss(logp, b["label"], b["umask"].double())
        grads = dict(zip(live, torch.autograd.grad(loss, list(live.values()),
                                                   allow_unused=True)))
        params = {n: p.detach() for n, p in live.items()}
        raw_norms.append(leaf_norms(grads))
        if first is None:
            first = leaf_norms({n: None if g is None else g + tr["weight_decay"] * params[n]
                                for n, g in grads.items()})
        common.adam_step(params, grads, state, tr["lr"], tr["weight_decay"])
        losses.append(float(loss.detach()))
    change = leaf_norms({n: params[n] - start[n] for n in params})
    return losses, first, raw_norms, change


def run(cell, seed: int, seconds: float, trace: bool, ctx) -> Outcome:
    torch, device = ctx.torch, ctx.device
    from ser_tpu_torch.train.trainer import ModelTrainer

    cfg, tr = cell.config, cell.traffic
    epochs, check, utts_per_epoch = data(cell, seed)
    ctx.phase("data")
    weights = make_weights(cell.reference.param_table(cfg["classes"]), sub_seed(seed, 2), device)
    trainer = ModelTrainer(device=device, model=cfg["model"], seed=sub_seed(seed, 3),
                           lr=tr["lr"], lr_decay=tr["lr_decay"],
                           weight_decay=tr["weight_decay"], n_classes=cfg["classes"])
    trainer.model.load_state_dict(weights, strict=True)
    optimizer_start = copy.deepcopy(trainer.optimizer.state_dict())
    ctx.phase("program")
    ctx.plant(trainer)

    # one warm-up step at each shape of the window
    warm = {}
    for batches in epochs:
        for b in batches:
            warm.setdefault(generate.shape_of(b), b)
    trainer.train_network(1, list(warm.values()))
    ctx.synchronize()
    setup_peak = ctx.memory_peak(reset=True)
    ctx.window_opens()

    shapes, failed, epoch, ends = [], 0, 0, []
    t0 = time.perf_counter()
    while True:
        batches = epochs[epoch % len(epochs)]
        _, loss = trainer.train_network(1 + epoch, batches)
        shapes.extend(generate.shape_of(b) for b in batches)
        failed += 0 if np.isfinite(loss) else len(batches)
        epoch += 1
        elapsed = time.perf_counter() - t0
        ends.append(elapsed)
        if elapsed >= seconds:
            break
    ctx.window_closes()
    readings = Readings(timed_shapes=shapes, timed_s=elapsed, reference=cell.reference,
                        config=cfg, on_device=ctx.on_device)
    if trace:
        traced = [epochs[(epoch + k) % len(epochs)] for k in range(tr["trace_epochs"])]
        readings.trace = profile_slice(torch, lambda: [
            trainer.train_network(1 + epoch + k, b) for k, b in enumerate(traced)])
        readings.slice_shapes = [generate.shape_of(b) for bs in traced for b in bs]
    window_peak = ctx.memory_peak()
    readings.reserved_peak_bytes = ctx.reserved_peak()

    losses, first, change = check_steps(trainer, weights, optimizer_start, check)
    del trainer
    gc.collect()
    ctx.free()
    ref_losses, ref_first, ref_raw, ref_change = reference_steps(
        torch, cell, weights, check, device)
    unmoved = compare.unmoved_leaves(ref_raw)
    grads = compare.norm_gaps(first, ref_first)
    changes = compare.norm_gaps(change, ref_change, skip=unmoved)
    live = [grads[n] for n, r in ref_first.items() if r > 0]
    moved = [changes[n] for n, r in ref_change.items() if r > 0 and n in changes]
    # np.max and np.median, not max: a NaN reading must come through (and fail)
    compared = {"loss_gap": float(np.max(np.abs(np.subtract(losses, ref_losses))
                                         / np.abs(ref_losses))),
                "head_grad_gap": float(np.max([grads[n] for n in
                                               cell.reference.SMOOTH_LEAVES])),
                "grad_median_gap": float(np.median(live)),
                "change_gap": float(np.max(list(changes.values()))),
                "change_median_gap": float(np.median(moved))}
    e2e = {"train_utts_per_s": epoch * utts_per_epoch / elapsed,
           "train_peak_gib": window_peak / 2 ** 30}
    return Outcome(e2e, readings, len(shapes), failed, compared,
                   max(setup_peak, window_peak),
                   {"grad_gap": max(grads.values()), "grad_leaf": max(grads, key=grads.get),
                    "change_leaf": max(changes, key=changes.get),
                    "unmoved": sorted(unmoved), "losses": losses,
                    "reference_losses": ref_losses,
                    "thirds": rate_by_thirds(ends, utts_per_epoch)})
