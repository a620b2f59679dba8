"""Profiling and NaN checks (counterpart of ``ser_tpu/utils/profiling.py``).

- ``trace(logdir)``: a ``torch.profiler`` trace of everything run inside,
  written to ``logdir`` for TensorBoard or Perfetto;
- ``annotate(name)``: one of the program's spans (``SPANS``), a
  ``record_function`` range on the profiler's clock while a profiler is
  collecting, and a shared no-op context otherwise;
- ``enable_nan_checks()``: ``--debug_nans``. The first NaN or inf in a
  train step's forward outputs or loss raises ``FloatingPointError`` (the
  type ``jax_debug_nans`` raises), and autograd's anomaly mode finds one in
  the backward, re-raised as that type by ``backward``. Each check is a sync
  with the host; with the checks off there is none, and the numbers are the
  same either way.
"""

from __future__ import annotations

import contextlib

import torch

_NAN_CHECKS = False

# The program's spans, each at a layer boundary of a train step or a scoring
# request, once a step or request. On the card the profiler also records a
# device-side annotation under each span's name; a name with ``#`` marks it
# as an annotation and not a kernel, as PyTorch's own ``Optimizer.step#...``.
SPANS = (
    "ser#train.step",   # ModelTrainer._train_step_impl, the whole step
    "ser#request",      # Predictor.predict and predict_batch
    "ser#inputs",       # Predictor.batch_inputs: the text mean, the copies
    "ser#forward",      # the model's call in a train step or a request
    "ser#recurrence",   # the bidirectional loop (MARN1, DialogueRNN), or onlysp's eval kernel
    "ser#backward",     # autograd's backward of a train step
    "ser#graph.capture",  # the capture of a train step's CUDA graph
    "ser#graph.replay",   # the replay of a train step's CUDA graph
)
_OFF = contextlib.nullcontext()


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
    """The span ``name`` (one of ``SPANS``): a ``record_function`` range
    while a ``torch.profiler.profile`` is open, else one shared
    ``nullcontext``, which costs no torch op. The profiler's own flag
    decides; nothing else turns the spans on."""
    if not torch.autograd.profiler._is_profiler_enabled:
        return _OFF
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

