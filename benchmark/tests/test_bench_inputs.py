"""The reference's input and the batches of a configuration of another
family: ``common.reference_input`` takes the reference module's own
``inputs``, and MARN1's builds x exactly as the drivers did; a
trimodal configuration's batches (visual features from ``visual_width``)
run through the program's trainer and predictor on the CPU."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import generate, score_requests, train_epochs
from benchmark.cell import HERE, load_json
from benchmark.reference import common
from benchmark.tests.small import SMALL, small_cell

SEED = 2 ** 31 + 6007
TRAIN = load_json(HERE / "traffic" / "iemocap-train-epochs.json")
TEST = load_json(HERE / "traffic" / "iemocap-test-requests.json")
# DialogueRNN on IEMOCAP: x = [text mean's first 100 | audio 100 | visual 512]
TRIMODAL = {"model": "DialogueRNN", "text_views": 4, "text_width": 1024, "audio_width": 100,
            "visual_width": 512, "input_width": 712, "parties": 2, "classes": 6}


@pytest.mark.parametrize("workload", ["onlysp.train.iemocap", "nsps.score.iemocap-test"])
def test_marn1_input_is_text_mean_then_audio(workload):
    # one cell of each MARN1 configuration, whose modules name MARN1's inputs
    cell = small_cell(workload)
    assert cell.reference.inputs is common.marn1_inputs
    (batch,) = generate.requests([3, 5, 4], cell.config, 1, np.random.default_rng(SEED))
    b = {k: torch.as_tensor(v) for k, v in batch.items()}
    r1, r2, r3, r4 = (b[f"r{k}"].double() for k in range(1, 5))
    want = torch.cat([(((r1 + r2) + r3) + r4) / 4, b["acouf"].double()], -1)
    got = common.reference_input(cell, b)
    assert got.dtype == torch.float64 and torch.equal(got, want)


def test_reference_inputs_hook_is_called():
    seen = []

    def inputs(batch, config):
        seen.append((batch, config))
        return "x"

    cell = SimpleNamespace(reference=SimpleNamespace(inputs=inputs), config=TRIMODAL)
    batch = {"r1": torch.zeros(2, 1, 3)}
    assert common.reference_input(cell, batch) == "x"
    assert seen == [(batch, TRIMODAL)]


def test_trimodal_batches_run_through_the_program():
    from ser_tpu_torch.serving import Predictor
    from ser_tpu_torch.train.trainer import ModelTrainer

    train = SimpleNamespace(config=TRIMODAL, traffic={**TRAIN, **SMALL["train_epochs"]})
    epochs, check, _ = train_epochs.data(train, SEED)
    for batch in epochs[0] + check:
        L, B = generate.shape_of(batch)
        assert batch["visuf"].shape == (L, B, TRIMODAL["visual_width"])
    trainer = ModelTrainer(device="cpu", model="DialogueRNN", seed=1,
                           n_classes=TRIMODAL["classes"])
    _, loss = trainer.train_network(1, epochs[0])
    assert np.isfinite(loss)

    score = SimpleNamespace(config=TRIMODAL, traffic={**TEST, **SMALL["score_requests"]})
    predictor = Predictor("DialogueRNN", device="cpu", n_classes=TRIMODAL["classes"])
    for batch in score_requests.data(score, SEED):
        logp, labels = predictor.predict_batch(batch)
        L, B = generate.shape_of(batch)
        assert logp.shape == (B * L, TRIMODAL["classes"]) and labels.shape == (B, L)
        assert torch.isfinite(logp).all()
