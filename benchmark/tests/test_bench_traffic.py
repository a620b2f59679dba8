"""The traffic generator: deterministic in the seed, the splits' counts
kept, the same work for every seed, and the same bytes as before a
configuration could bring visual features."""

import hashlib
from types import SimpleNamespace

import numpy as np
import pytest

from benchmark import generate, score_requests, train_epochs
from benchmark.cell import HERE, load_json
from benchmark.tests.small import SMALL

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


# sha256 of the small traffic's train epochs, check batches and score pool
# (every array's name, dtype, shape and bytes, in order), for each seed, as
# the generator made them before a configuration could give
# ``visual_width``: a configuration without it draws the same bytes
PINNED = {
    2 ** 31 + 4099: ("fadeca7baab8e5b78db919e73da119e27fbe2fcd2fda48c369bd2c23e37079cf",
                     "1ea8fc25e0c836afdc8170619519d8a8d3ff5f8e36a2897df361b4e854dd8d10",
                     "73caa1707754747e4444c6dac0a7b6599555e6e3679cd15e1839adfe1cc2e23d"),
    3_000_000_019: ("fc34529daf70a716e912f5b2ad55517e678d8ad5b3f43fe691a5df9c39b05c07",
                    "37ad164988ac40191ba0d8d07df0a287c62bc047570b25eb11bcf0aeeaacad7b",
                    "9f6a4ef9c95028b1d54b9639e92fb368c7120c80f6a97b4d1959ab0e5300f64d"),
}


def digest(batches) -> str:
    h = hashlib.sha256()
    for batch in batches:
        for name, a in batch.items():
            h.update(f"{name}{a.dtype}{a.shape}".encode())
            h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("config", ["MARN1_onlysp.iemocap", "MARN1_nsps.iemocap"])
@pytest.mark.parametrize("seed", PINNED)
def test_data_is_the_pinned_bytes(config, seed):
    cfg = load_json(HERE / "configs" / f"{config}.json")
    train = SimpleNamespace(config=cfg, traffic={**TRAIN, **SMALL["train_epochs"]})
    score = SimpleNamespace(config=cfg, traffic={**TEST, **SMALL["score_requests"]})
    epochs, check, utts = train_epochs.data(train, seed)
    got = (digest(b for epoch in epochs for b in epoch), digest(check),
           digest(score_requests.data(score, seed)))
    assert utts == SMALL["train_epochs"]["utterances"]
    assert got == PINNED[seed]


def test_visual_features_from_the_configuration():
    # a configuration with visual_width draws one more N(0, 1) vector an
    # utterance, after the others: the rest of the batch is as without it
    plain = load_json(HERE / "configs" / "MARN1_onlysp.iemocap.json")
    lengths = generate.split_lengths({**TEST, **SMALL["score_requests"]})
    (a,) = generate.requests(lengths, plain, 1, np.random.default_rng([BIG, 1]))
    (b,) = generate.requests(lengths, {**plain, "visual_width": 512}, 1,
                             np.random.default_rng([BIG, 1]))
    assert "visuf" not in a and list(b) == ["r1", "r2", "r3", "r4", "acouf", "visuf", "qmask",
                                            "umask", "label"]
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    L, B = generate.shape_of(b)
    assert b["visuf"].shape == (L, B, 512) and b["visuf"].dtype == np.float32
    valid = b["umask"].T > 0
    assert not b["visuf"][~valid].any() and (b["visuf"][valid] != 0).all()
    rows = b["visuf"][valid]
    assert len(np.unique(rows, axis=0)) == len(rows) and abs(rows.std() - 1) < 0.05
