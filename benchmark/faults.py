"""Faults planted in the program object under the timed path, for the
benchmark's tests and its calibration (``benchmark.calibrate``): each must
make a run's ``correct`` false. A fault is ``plant(program)``, applied to
the trainer or the predictor right after set-up builds it."""

from __future__ import annotations


def state_unchanged(trainer) -> None:
    """A train step that returns its state unchanged: Adam does nothing."""
    trainer.optimizer.step = lambda closure=None: None


def half_of(batch: dict) -> dict:
    """The batch's first half of dialogues."""
    keep = batch["umask"].shape[0] // 2
    return {k: (v[:keep] if k in ("umask", "label") else v[:, :keep]) for k, v in batch.items()}


def half_batch(trainer) -> None:
    """Half of every batch left out: each step's mean is over the rest."""
    train_network = trainer.train_network
    trainer.train_network = lambda epoch, batches: train_network(
        epoch, [half_of(b) for b in batches])


def answer_altered(predictor) -> None:
    """One answer altered where it is produced: the first row of every
    request's log-probabilities rolled by one class."""
    predict_batch = predictor.predict_batch

    def altered(batch):
        logp, labels = predict_batch(batch)
        logp = logp.clone()
        logp[0] = logp[0].roll(1)
        return logp, labels

    predictor.predict_batch = altered


TRAIN = {"state_unchanged": state_unchanged, "half_batch": half_batch}
SCORE = {"answer_altered": answer_altered}
