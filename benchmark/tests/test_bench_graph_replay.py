"""The reader of ``train.graph_replay_pct`` on hand-built traces: two
steps that both replay, one that does, none, and no trace."""

import pytest

from benchmark.cell import Readings, read_metric
from benchmark.trace import Trace

MS = 1_000_000  # ns


def steps(replayed) -> Trace:
    """Train steps of 40 ms, 10 ms apart; ``replayed[i]`` says whether the
    i-th holds a replay span."""
    host = []
    for i, replay in enumerate(replayed):
        t0 = 50 * MS * i
        host += [("ser#train.step", t0, t0 + 40 * MS), ("ser#inputs", t0, t0 + 2 * MS)]
        if replay:
            host.append(("ser#graph.replay", t0 + 3 * MS, t0 + 4 * MS))
        else:
            host.append(("ser#forward", t0 + 2 * MS, t0 + 20 * MS))
    return Trace(0, 50 * MS * len(replayed), kernels=[("k", 0, MS)], host=host)


@pytest.mark.parametrize("replayed, share", [((True, True), 100.0), ((True, False), 50.0),
                                             ((False, False), 0.0)])
def test_graph_replay_share_of_the_slice_steps(replayed, share):
    run = Readings(trace=steps(replayed), slice_shapes=[[110, 80], [103, 40]])
    assert read_metric("train.graph_replay_pct", run) == pytest.approx(share)


def test_graph_replay_share_without_a_trace_is_none():
    assert read_metric("train.graph_replay_pct", Readings(slice_shapes=[[110, 80]])) is None
    assert read_metric("train.graph_replay_pct", Readings(trace=steps((True,)))) is None
