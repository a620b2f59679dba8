"""Weight carriers between the JAX package's checkpoints, the reference's
torch checkpoints and the port (``from_jax``, ``torch_import``).

The public import API of ``torch_import`` is read from this package at first
use: ``train/checkpoint.py``, which it is built on, itself imports
``compat.from_jax``.
"""

__all__ = ["convert_state_dict", "import_torch_checkpoint", "load_torch_state_dict"]


def __getattr__(name):
    if name in __all__:
        from ser_tpu_torch.compat import torch_import

        return getattr(torch_import, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
