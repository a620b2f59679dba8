"""The numbers that decide ``correct``: the program's outputs against the
reference's, each reduced to one number that its cell's limit holds.

Train cells (the check steps through the window's own call, on the warmed
trainer after the window, with every dropout rate at 0):

- ``loss_gap``: the widest relative gap of a step's loss;
- ``head_grad_gap``: the first gradient as Adam got it (its first moment
  after one step over ``1 - beta1``, the coupled decay included) against
  the reference's, by the worst leaf between the loss and the model's last
  ReLU (the reference module's ``SMOOTH_LEAVES``, the head's output layer):
  the gap between the two norms over the reference's norm of that leaf or
  the median leaf's, whichever is larger. Behind a ReLU the gradient has a
  kink: where a ReLU's input lies within rounding of 0, float32 and float64
  take different sides, and every leaf behind it moves by about one row's
  share of the gradient. The leaves in front of every ReLU see no kink;
- ``grad_median_gap``: the same gaps of the first gradient, the median
  over every leaf that the reference reaches: a fault behind the head that
  moves half the leaves shows here, a kink's row share less so;
- ``change_gap``: each parameter's change over the steps, by the same rule
  over every leaf. A leaf whose gradient the reference finds under a
  thousandth of the median leaf's at every step moves under Adam by
  rounding alone and is left out; a leaf that the reference never reaches
  (no gradient) counts, and its change must be 0. Adam's step is about
  ``lr`` times the sign of an element's gradient where that is small, so
  an element whose gradient is within rounding of 0 moves either way: the
  worst leaf swings from seed to seed;
- ``change_median_gap``: the median of those gaps over the leaves that the
  reference moves. About 6e-6 on most seeds (the program's Adam takes its
  bias corrections in float32); on a few seeds up to 6.3e-4, where float32
  puts ReLU inputs near 0 on the other side, Adam moves the elements whose
  gradient is within rounding of 0 by about ``lr`` either way, and the
  later steps' forwards flip more of them (a float32 reference does the
  same).

Score cells (every answer of the window against the reference's answer to
its request):

- ``answer_gap``: over the valid rows, the wider of the widest gap of a
  log-probability and the gap by which the reference's log-probability of
  the program's label lies below the reference's best (0 where they agree;
  a near tie may flip a label, which costs only the tie's width).
"""

from __future__ import annotations

import numpy as np

RELATIVE_GRADIENT_FLOOR = 1e-3


def norm_gaps(prog: dict, ref: dict, skip=()) -> dict:
    """Each leaf's ``|prog - ref| / max(ref, median ref)``; ``prog`` and
    ``ref`` map a leaf's name to its norm, 0 for a leaf with none."""
    live = [v for v in ref.values() if v > 0]
    median = float(np.median(live)) if live else 1.0
    return {n: abs(prog.get(n, 0.0) - r) / max(r, median)
            for n, r in ref.items() if n not in skip}


def unmoved_leaves(ref_grad_norms: list[dict]) -> set:
    """The leaves whose reference gradient is under
    ``RELATIVE_GRADIENT_FLOOR`` of the median leaf's at every step."""
    out = None
    for norms in ref_grad_norms:
        live = [v for v in norms.values() if v > 0]
        floor = RELATIVE_GRADIENT_FLOOR * float(np.median(live)) if live else 0.0
        small = {n for n, v in norms.items() if 0 < v < floor}
        out = small if out is None else out & small
    return out or set()


def score_gaps(answers, references) -> tuple[dict, int]:
    """``({answer_gap}, failed)`` over ``answers`` ``[(pool index,
    logp [B*L, C], labels [B, L], umask [B, L])]`` against ``references``
    (pool index -> the reference's logp ``[B*L, C]``, float64). An answer
    of another shape, with a value that is not finite or a label that is
    not a class on a valid row, is failed and sets the gap to infinity."""
    gap = 0.0
    failed = 0
    for k, logp, labels, umask in answers:
        ref = references[k]
        valid = umask.reshape(-1) > 0
        if (logp.shape != ref.shape or labels.shape != umask.shape
                or not np.isfinite(logp[valid]).all()
                or not np.isin(labels.reshape(-1)[valid], np.arange(ref.shape[1])).all()):
            failed += 1
            gap = float("inf")
            continue
        r = ref[valid]
        picked = np.take_along_axis(r, labels.reshape(-1)[valid][:, None].astype(np.int64), 1)
        gap = max(gap, float(np.abs(logp[valid] - r).max()),
                  float((r.max(1) - picked[:, 0]).max()))
    return {"answer_gap": gap}, failed
