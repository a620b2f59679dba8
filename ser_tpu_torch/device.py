"""The device rule and the fp32 numerics switch.

Entry points default to ``cuda``. Where CUDA is missing they raise unless
the caller asked for the CPU: the port never falls back silently.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device without CUDA raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def disable_tf32() -> None:
    """Full-f32 matmuls and convolutions: the logit contract (rtol 1e-3
    against the JAX package) is an fp32 contract, and cuDNN defaults to TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
