"""On-device audio front end: raw waveforms -> the 100-d audio feature slot
(counterpart of ``ser_tpu/data/frontend.py``).

``out_dim // 2`` MFCC coefficients, mean- and std-pooled over frames, give
``out_dim`` floats per utterance (100 by default, the reference's audio
slot, so the model consumes it unchanged). On a CUDA tensor the MFCCs come
from the CUDA kernel (``ops/mfcc.py::mfcc``).
"""

from __future__ import annotations

import torch

from ser_tpu_torch.ops.mfcc import MFCCConfig, mfcc


class MFCCFrontend:
    """Maps padded waveforms [L, B, T] -> audio features [L, B, out_dim]."""

    def __init__(self, out_dim: int = 100, sr: int = 16000, n_fft: int = 512,
                 win_length: int = 400, hop: int = 160, n_mels: int = 64):
        if out_dim % 2:
            raise ValueError("out_dim must be even (mean+std pooling)")
        self.out_dim = out_dim
        self.cfg = MFCCConfig(sr=sr, n_fft=n_fft, win_length=win_length,
                              hop=hop, n_mels=n_mels, n_mfcc=out_dim // 2)

    def __call__(self, wav: torch.Tensor, wav_len: torch.Tensor | None = None):
        """wav: [L, B, T] (or [N, T]) padded waveforms. All-zero rows (batch
        padding) give a constant, finite feature vector (mean log-eps
        energy, std 0).

        wav_len: optional [B] per-dialogue sample counts. Pooling then covers
        only the frames inside the real samples; row ``l*B + b`` takes
        dialogue b's frame mask. A dialogue shorter than one frame pools
        over no frame and gives zeros."""
        squeeze = wav.ndim == 2
        if squeeze:
            wav = wav[None]
        L, B, T = wav.shape
        feats = mfcc(wav.reshape(L * B, T).contiguous(), self.cfg)
        F = feats.shape[1]
        if wav_len is None:
            mean = feats.mean(dim=1)
            var = (feats - mean[:, None]).square().mean(dim=1)
        else:
            n_valid = torch.clamp(
                1 + (wav_len.to(torch.int32) - self.cfg.win_length)
                // self.cfg.hop, min=0)  # frames per dialogue, [B]
            fmask = (torch.arange(F, device=feats.device)[None, :]
                     < n_valid[:, None]).to(feats.dtype)  # [B, F]
            fmask = fmask.repeat(L, 1)[:, :, None]  # [L*B, F, 1], tiled over L
            denom = torch.clamp(fmask.sum(dim=1), min=1.0)
            mean = (feats * fmask).sum(dim=1) / denom
            var = ((feats - mean[:, None]).square() * fmask).sum(dim=1) / denom
        std = torch.sqrt(torch.clamp(var, min=0.0))
        out = torch.cat([mean, std], dim=-1).reshape(L, B, self.out_dim)
        return out[0] if squeeze else out


FRONTENDS = {"mfcc": MFCCFrontend}


def make_frontend(name: str | None, **kwargs):
    if name in (None, "", "none"):
        return None
    if name not in FRONTENDS:
        raise KeyError(
            f"unknown audio frontend '{name}'; available: {sorted(FRONTENDS)}")
    return FRONTENDS[name](**kwargs)
