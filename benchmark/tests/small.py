"""Small traffic for the CPU tests: the cells' own files with a handful of
short dialogues, at the configurations' full widths."""

from __future__ import annotations

from benchmark.cell import HERE, load_cell, load_json

SMALL = {
    "train_epochs": dict(dialogues=6, utterances=40, length_low=4, max_len=9,
                         min_len=2, batch_size=4, shuffles=2, check_steps=3),
    "score_requests": dict(dialogues=3, utterances=20, length_low=4, length_high=9,
                           min_len=2, pool=2, warmup_requests=1, trace_requests=2),
}


def small_cell(workload: str):
    """The cell with its traffic cut to a few short dialogues."""
    full = load_cell(workload)
    traffic = load_json(HERE / "traffic" / f"{full.workload['traffic']}.json")
    return load_cell(workload, traffic={**traffic, **SMALL[traffic["driver"]]})
