"""The traffic generator: deterministic in the seed, the splits' counts
kept, and the same work for every seed."""

import numpy as np
import pytest

from benchmark import generate, train_epochs
from benchmark.cell import HERE, load_json

TRAIN = load_json(HERE / "traffic" / "iemocap-train-epochs.json")
TEST = load_json(HERE / "traffic" / "iemocap-test-requests.json")
CONFIG = load_json(HERE / "configs" / "MARN1_onlysp.iemocap.json")
BIG = 2 ** 31 + 977  # the driver's seeds pass 32 signed bits


@pytest.mark.parametrize("spec, dialogues, utterances", [(TRAIN, 120, 5810), (TEST, 31, 1623)])
def test_split_counts(spec, dialogues, utterances):
    lengths = generate.split_lengths(spec)
    assert len(lengths) == dialogues and lengths.sum() == utterances
    assert lengths.min() >= spec["min_len"] and lengths.max() <= spec["max_len"]


def test_requests_deterministic_and_same_work():
    lengths = generate.split_lengths(TEST)
    a = generate.requests(lengths, CONFIG, 2, np.random.default_rng([BIG, 1]))
    b = generate.requests(lengths, CONFIG, 2, np.random.default_rng([BIG, 1]))
    c = generate.requests(lengths, CONFIG, 2, np.random.default_rng([BIG + 1, 1]))
    for x, y, z in zip(a, b, c):
        assert x.keys() == y.keys()
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])
        assert not np.array_equal(x["r1"], z["r1"])
        assert generate.shape_of(x) == generate.shape_of(z) == (lengths.max(), 31)
        assert generate.valid_utterances(x) == generate.valid_utterances(z) == 1623
        np.testing.assert_array_equal(np.sort(x["umask"].sum(1)), np.sort(lengths))
        # a padded step has no speaker; a valid one exactly one
        np.testing.assert_array_equal(x["qmask"].sum(-1), x["umask"].T)


def test_train_split_has_the_longest_dialogue():
    # IEMOCAP's train and valid sessions: 120 dialogues, 5,810 utterances, the
    # longest 110 (the reference pads train batches to 110)
    lengths = generate.split_lengths(TRAIN)
    assert lengths.max() == TRAIN["max_len"] == 110
    assert (lengths >= 100).sum() >= 5


def test_epochs_cover_the_split_and_check_rows_differ():
    class Cell:
        config, traffic = CONFIG, TRAIN

    e1, check1, utts = train_epochs.data(Cell, BIG)
    e2, check2, _ = train_epochs.data(Cell, BIG)
    assert utts == 5810 and len(e1) == TRAIN["shuffles"]
    for epoch in e1:
        assert [b["umask"].shape[0] for b in epoch] == [80, 40]
        assert sum(generate.valid_utterances(b) for b in epoch) == 5810
    # the check steps take the shapes of the window's first batches
    window = [b for epoch in e1 for b in epoch][:TRAIN["check_steps"]]
    assert [generate.shape_of(b) for b in check1] == [generate.shape_of(b) for b in window]
    for x, y in zip(check1, check2):
        np.testing.assert_array_equal(x["r2"], y["r2"])
    rows = np.concatenate([b["acouf"][0] for b in check1])
    assert len(np.unique(rows, axis=0)) == len(rows)


def test_every_seed_trains_the_same_shapes():
    class Cell:
        config, traffic = CONFIG, {**TRAIN, "utterances": 250, "dialogues": 10,
                                   "batch_size": 4, "max_len": 40}

    shapes = [sorted(generate.shape_of(b) for epoch in train_epochs.data(Cell, s)[0]
                     for b in epoch) for s in (BIG, BIG + 1, 7)]
    assert shapes[0] == shapes[1] == shapes[2]
