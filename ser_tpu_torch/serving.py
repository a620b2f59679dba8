"""The port's eval forward as a server object.

``Predictor`` is the counterpart of the eval forward behind the JAX
package's ``predict.py`` (``ModelTrainer.eval_network``): it owns one model
on its device in eval mode and answers padded requests.
"""

from __future__ import annotations

import torch

from ser_tpu_torch.device import resolve_device
from ser_tpu_torch.models.registry import build_model
from ser_tpu_torch.ops.init import generator


class Predictor:
    """A model on one device, answering padded requests.

    ``state_dict`` holds reference-layout weights (for example from
    ``compat.from_jax.from_jax_params``); without it the weights are the
    torch-default init drawn from ``seed``. ``device`` defaults to ``cuda``
    and raises where CUDA is missing, unless it is ``"cpu"``.
    """

    def __init__(self, model_name: str = "MARN1_onlysp", state_dict=None,
                 seed: int = 0, device=None):
        self.device = resolve_device(device)
        model = build_model(model_name, generator(seed))
        if state_dict is not None:
            model.load_state_dict(state_dict, strict=True)
        self.model = model.to(self.device).eval()
        self.n_requests = 0

    def predict(self, x, qmask, umask):
        """One padded request: x ``[L, B, 1124]``, qmask ``[L, B, 2]``,
        umask ``[B, L]``. Returns ``(logp [B*L, C], labels [B, L])`` on the
        predictor's device."""
        with torch.inference_mode():
            x, qmask, umask = (
                torch.as_tensor(a, dtype=torch.float32, device=self.device)
                for a in (x, qmask, umask))
            logp = self.model(x, qmask, umask)[0]
            labels = logp.argmax(-1).reshape(umask.shape)
        self.n_requests += 1
        return logp, labels
