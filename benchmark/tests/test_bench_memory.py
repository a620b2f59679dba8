"""The reader of ``train.reserved_peak_gib`` on stand-in readings: a
traced slice with the reserved peak that a run on the card reads, and
without it, as off the card."""

import pytest
import torch

from benchmark.cell import Readings, read_metric
from benchmark.run import Context
from benchmark.trace import Trace

MS = 1_000_000  # ns


def slice_readings(**kw) -> Readings:
    trace = Trace(0, 50 * MS, kernels=[("k", 0, MS)], host=[("ser#train.step", 0, 40 * MS)])
    return Readings(trace=trace, slice_shapes=[[110, 80]], **kw)


def test_reserved_peak_read_on_the_card():
    run = slice_readings(on_device=True, reserved_peak_bytes=3_082_813_440)
    assert read_metric("train.reserved_peak_gib", run) == pytest.approx(2.871093750)


def test_reserved_peak_is_none_off_the_card():
    assert Context(torch, "cpu").reserved_peak() is None
    assert read_metric("train.reserved_peak_gib", slice_readings()) is None
    assert read_metric("train.reserved_peak_gib", Readings()) is None
