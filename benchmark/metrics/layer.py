"""What several readers share: counts and device time a step or a request
of the traced slice, and the share of the FP32 peak of the untraced part."""

from __future__ import annotations

from benchmark.peaks import F32_FLOPS


def has_device(run) -> bool:
    """Whether the slice holds device records to read."""
    return run.trace is not None and bool(run.trace.kernels)


def launches_per_item(run):
    """Kernels the device ran in the slice, over its steps or requests."""
    if not has_device(run):
        return None
    return len(run.trace.kernels) / len(run.slice_shapes)


def h2d_ms_per_item(run):
    """Device ms of host-to-device copies in the slice, a step or a request."""
    if not has_device(run):
        return None
    return 1e3 * run.trace.device_seconds(("HtoD",)) / len(run.slice_shapes)


def idle_pct(run):
    """Share of the slice's window in which the device ran nothing."""
    if not has_device(run):
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def mfu_pct(run, train: bool):
    """The reference's matrix-product FLOPs of the untraced part's steps or
    requests over its time, against the FP32 peak."""
    flops = getattr(run.reference, "matmul_flops", None)
    if flops is None or not run.timed_shapes or run.timed_s <= 0 or not run.on_device:
        return None
    total = sum(flops(L, B, train) for L, B in run.timed_shapes)
    return 100.0 * total / run.timed_s / F32_FLOPS
