"""Profiling and NaN checks (counterpart of ``ser_tpu/utils/profiling.py``).

- ``trace(logdir)``: a ``torch.profiler`` trace of everything run inside,
  written to ``logdir`` for TensorBoard or Perfetto;
- ``annotate(name)``: a named region in such a trace (``record_function``);
- ``StepTimer``: wall-clock time a named phase, on the host's clock;
- ``enable_nan_checks()``: ``--debug_nans``. The first NaN or inf in a
  train step's forward outputs or loss raises ``FloatingPointError`` (the
  type ``jax_debug_nans`` raises), and autograd's anomaly mode finds one in
  the backward, re-raised as that type by ``backward``. Each check is a sync
  with the host; with the checks off there is none, and the numbers are the
  same either way.
"""

from __future__ import annotations

import contextlib
import time

import torch

_NAN_CHECKS = False


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the CPU and, where there is one, the card, into ``logdir``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)):
        yield


def annotate(name: str):
    """A named region that shows in profiler traces."""
    return torch.profiler.record_function(name)


def enable_nan_checks(enable: bool = True) -> None:
    """Turn the NaN checks of every train step on or off, autograd's anomaly
    mode with them."""
    global _NAN_CHECKS
    _NAN_CHECKS = bool(enable)
    torch.autograd.set_detect_anomaly(_NAN_CHECKS)


def nan_checks_enabled() -> bool:
    return _NAN_CHECKS


def check_finite(what: str, *tensors: torch.Tensor) -> None:
    """With the checks on, ``FloatingPointError`` if a tensor holds a NaN or
    an inf; with them off, nothing."""
    if not _NAN_CHECKS:
        return
    for t in tensors:
        if not bool(torch.isfinite(t).all()):
            raise FloatingPointError(f"NaN or inf in {what} (--debug_nans)")


def backward(loss: torch.Tensor) -> None:
    """``loss.backward()``; with the checks on, anomaly mode's error on a
    NaN that the backward makes is raised as ``FloatingPointError``."""
    try:
        loss.backward()
    except RuntimeError as e:
        if _NAN_CHECKS and "nan" in str(e).lower():
            raise FloatingPointError(f"{e} (--debug_nans)") from e
        raise


class StepTimer:
    """Wall-clock time a named phase, on the host's clock."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def time(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> dict:
        return {name: {"total_s": round(self.totals[name], 4), "count": self.counts[name],
                       "mean_ms": round(1e3 * self.totals[name] / self.counts[name], 3)}
                for name in self.totals}
