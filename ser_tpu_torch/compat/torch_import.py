"""Reference torch checkpoints into the port (counterpart of the public API
of ``ser_tpu/compat/torch_import.py``).

The reference saves ``torch.save(self.state_dict())`` of its whole trainer
(``model_trainer.py:170-187``). The port's modules keep the reference's
keys, so the import is the key handling of ``train/checkpoint.py``: each key
loses a leading ``module.`` (DataParallel's) and then ``model.`` (the
trainer's); the model's keys the file lacks print ``<key> is not in the
checkpoint.``, the file's keys the model lacks ``<key> is not in the
model.``, a shape mismatch ``Wrong parameter length: ...``, and each of
those is skipped while everything else is copied (the reference's partial
load). The names and messages are the JAX package's; where it returns a flax
parameter tree, these return or fill the port's state dict.

    import_torch_checkpoint(model, "model_0042.model", "MARN1_onlysp")
"""

from __future__ import annotations

import torch

from ser_tpu_torch.models.registry import build_model
from ser_tpu_torch.ops.init import generator
from ser_tpu_torch.train.checkpoint import load_checked, load_torch_state_dict, place_torch


def convert_state_dict(model_name: str, sd: dict, log=print) -> dict:
    """The entries of the prefix-stripped torch state dict ``sd`` that the
    registry's ``model_name`` has, as f32 CPU tensors, with a line for each
    key missing on either side. An unknown name raises ``KeyError`` listing
    the models."""
    own = build_model(model_name, generator(0)).state_dict()
    return place_torch(own, sd, log)


def import_torch_checkpoint(model: torch.nn.Module, path, model_name: str,
                            log=print) -> list[str]:
    """Load what fits of the reference checkpoint at ``path`` into
    ``model`` (the registry's ``model_name``); the rest keeps its values.
    Returns the loaded keys."""
    converted = convert_state_dict(model_name, load_torch_state_dict(path), log)
    return load_checked(model, [(k, k, v) for k, v in converted.items()], log)
