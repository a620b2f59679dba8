"""PyTorch/CUDA port of ``ser_tpu`` for one NVIDIA H100.

The package stands alone: it imports torch and numpy, and nothing of JAX or
of ``ser_tpu``. Its tests are where the two packages meet. Entry points run
on ``cuda`` unless the caller passes ``device="cpu"`` (see ``device.py``).
"""
