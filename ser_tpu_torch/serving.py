"""The port's eval forward as a server object.

``Predictor`` is the counterpart of the eval forward behind the JAX
package's ``predict.py`` (``ModelTrainer.eval_network``): it owns one model
on its device in eval mode and answers padded requests, either as model
inputs (``predict``) or as a collated batch (``predict_batch``), which may
carry raw waveforms for the on-device audio front end.
"""

from __future__ import annotations

import torch

from ser_tpu_torch.data.frontend import make_frontend
from ser_tpu_torch.device import resolve_device
from ser_tpu_torch.models.registry import get_model_spec
from ser_tpu_torch.ops.init import generator


class Predictor:
    """A model on one device, answering padded requests.

    ``state_dict`` holds reference-layout weights (for example from
    ``compat.from_jax.from_jax_params``); without it the weights are the
    torch-default init drawn from ``seed``. ``device`` defaults to ``cuda``
    and raises where CUDA is missing, unless it is ``"cpu"``.
    ``audio_frontend`` (None or ``"mfcc"``) computes the audio slot from the
    ``wav`` field of a batch given to ``predict_batch``.
    """

    def __init__(self, model_name: str = "MARN1_onlysp", state_dict=None,
                 seed: int = 0, device=None, audio_frontend: str | None = None,
                 n_classes: int = 6):
        self.device = resolve_device(device)
        self.spec = get_model_spec(model_name)
        model = self.spec.build(n_classes, generator(seed))
        if state_dict is not None:
            model.load_state_dict(state_dict, strict=True)
        # eval mode here; a trainer that shares the model switches it
        self.model = model.to(self.device).eval()
        self.frontend = make_frontend(audio_frontend)
        self.n_requests = 0

    def _tensor(self, a, dtype=torch.float32):
        return torch.as_tensor(a, dtype=dtype, device=self.device)

    def _answer(self, x, qmask, umask):
        logp = self.spec.extract_logp(self.model(x, qmask, umask))
        labels = self.spec.grid(logp.argmax(-1), *umask.shape)
        self.n_requests += 1
        return logp, labels

    def predict(self, x, qmask, umask):
        """One padded request: x ``[L, B, D]`` as the model's ``make_inputs``
        gives it (1124 wide for IEMOCAP and 1324 for MELD, 712 for the
        trimodal models on IEMOCAP), qmask ``[L, B, P]`` (for MARN1_onlysp
        P = 2 or 9, a party count the recurrence kernel was compiled for),
        umask ``[B, L]``. Returns ``(logp [B*L, C], labels [B, L])`` on the
        predictor's device: logp's rows in the model's order
        (``ModelSpec.logp_layout``; time-major for MARN_AT and MARN_ATV),
        log-probabilities or, for the models that emit them,
        probabilities."""
        with torch.inference_mode():
            return self._answer(*(self._tensor(a) for a in (x, qmask, umask)))

    def batch_inputs(self, batch):
        """``(x, qmask, umask)`` on the device from one collated batch
        (``data.collate``), numpy arrays. With an audio front end and a
        ``wav`` field, the waveforms (and ``wav_len``) are copied to the
        device and the front end computes ``acouf`` there; otherwise the
        batch's ``acouf`` is used. The text views are averaged on the host,
        so one of them is copied, not four (with the visual features for the
        trimodal models). The caller picks the grad mode."""
        textf = self._tensor(self.spec.text_features(batch))
        if self.frontend is not None and "wav" in batch:
            wav_len = batch.get("wav_len")
            acouf = self.frontend(
                self._tensor(batch["wav"]),
                None if wav_len is None else self._tensor(wav_len, torch.int32))
        else:
            acouf = self._tensor(batch["acouf"])
        return (self.spec.join_inputs(textf, acouf),
                self._tensor(batch["qmask"]), self._tensor(batch["umask"]))

    def predict_batch(self, batch):
        """One collated batch, as ``batch_inputs`` reads it. Returns what
        ``predict`` returns."""
        with torch.inference_mode():
            return self._answer(*self.batch_inputs(batch))
