"""The CUDA kernels on the card (marker ``cuda``; skips without CUDA).

Imports no JAX, so it also runs on a machine with the card and no JAX:
``python -m pytest tests/test_torch_cuda.py -m cuda --noconftest``.
Tolerances: the recurrence atol 1e-4 (another summation order over T serial
steps); the MFCC kernel rtol 1e-5, atol 2e-4 (its spectrum comes from an FFT
with the window applied first, the plain version's from dense products with
the window folded into the DFT matrices; then 64-term DCT sums of values up
to |log 1e-6| = 13.8).
"""

import numpy as np
import pytest
import torch

from ser_tpu_torch.device import disable_tf32
from ser_tpu_torch.ops.kernels import LAUNCHES
from ser_tpu_torch.ops.kernels import lsthm as tlsthm
from ser_tpu_torch.ops.kernels import mfcc as tmfcc_kernel
from ser_tpu_torch.ops.mfcc import MFCCConfig, mfcc, mfcc_ref

pytestmark = pytest.mark.cuda
H = 128


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; runs on the card")
    disable_tf32()
    return torch.device("cuda")


def _inputs(T, B, dev, padded_row=None):
    rng = np.random.default_rng(B)
    f = lambda *s: torch.from_numpy(
        (0.1 * rng.standard_normal(s)).astype(np.float32)).to(dev)
    qm = np.eye(2, dtype=np.float32)[rng.integers(0, 2, size=(T, 2, B))]
    qm[T // 2:, :, 0] = 0.0  # padded tail on row 0
    if padded_row is not None:
        qm[:, :, padded_row] = 0.0  # a row that is padding at every step
    seqs = (f(T, 2, B, 4 * H), f(T, 2, B, 4 * H), f(T, 2, B, 3 * H),
            torch.from_numpy(qm).to(dev))
    consts = (f(2, 3 * H, 4 * H), f(2, 4 * H), f(2, 3 * H, 4 * H),
              f(2, 4 * H), f(2, H, 3 * H), f(2, 3 * H), f(2, H), f(2, H))
    return seqs, consts


@pytest.mark.parametrize("B", [1, 8, 9, 31, 33])
def test_kernel_matches_plain_version(cuda, B):
    seqs, consts = _inputs(20, B, cuda)
    before = LAUNCHES[tlsthm.NAME]
    got = tlsthm.lsthm_onlysp_recurrence_bidir(seqs, consts)
    torch.cuda.synchronize()
    assert LAUNCHES[tlsthm.NAME] == before + 1
    want = tlsthm.lsthm_onlysp_recurrence_bidir_ref(seqs, consts)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def test_kernel_one_step(cuda):
    seqs, consts = _inputs(1, 9, cuda)
    got = tlsthm.lsthm_onlysp_recurrence_bidir(seqs, consts)
    torch.cuda.synchronize()
    want = tlsthm.lsthm_onlysp_recurrence_bidir_ref(seqs, consts)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def test_kernel_fully_padded_row(cuda):
    seqs, consts = _inputs(20, 9, cuda, padded_row=4)
    got = tlsthm.lsthm_onlysp_recurrence_bidir(seqs, consts)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    want = tlsthm.lsthm_onlysp_recurrence_bidir_ref(seqs, consts)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def test_kernel_two_runs_bit_equal(cuda):
    """A race in the cluster exchange would show as a run-to-run difference."""
    seqs, consts = _inputs(40, 31, cuda)
    runs = []
    for _ in range(3):
        runs.append(tlsthm.lsthm_onlysp_recurrence_bidir(seqs, consts))
        torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1]) and torch.equal(runs[0], runs[2])


def test_kernel_refuses_mixed_devices(cuda):
    seqs, consts = _inputs(3, 2, cuda)
    with pytest.raises(ValueError, match="xl_proj on"):
        tlsthm.lsthm_onlysp_recurrence_bidir(seqs, (consts[0].cpu(),) + consts[1:])


@pytest.mark.parametrize("N,T,n_mels,n_mfcc", [(37, 4096, 64, 50),
                                               (3, 16000, 40, 13)])
def test_mfcc_kernel_matches_plain_version(cuda, N, T, n_mels, n_mfcc):
    cfg = MFCCConfig(n_mels=n_mels, n_mfcc=n_mfcc)
    rng = np.random.default_rng(N)
    x = torch.from_numpy(rng.standard_normal((N, T)).astype(np.float32)).to(cuda)
    x[1] = 0.0  # padded rows: all-zero waveforms
    x[N - 1] = 0.0
    x[0, T // 3:] = 0.0  # a waveform that ends inside the bucket
    before = LAUNCHES[tmfcc_kernel.NAME]
    got = mfcc(x, cfg)
    torch.cuda.synchronize()
    assert LAUNCHES[tmfcc_kernel.NAME] == before + 1
    want = mfcc_ref(x, cfg)
    assert got.shape == (N, cfg.n_frames(T), n_mfcc)  # N*F is not a multiple of the tile
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=2e-4)
    torch.testing.assert_close(got[1], torch.full_like(got[1], 0.0) + got[1, 0],
                               rtol=0, atol=0)  # every padded frame alike


def _noise(shape, dev, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)


def _tone(dev, T=4096, hz=440.0):
    t = torch.arange(T, device=dev, dtype=torch.float64)
    return torch.sin(2 * np.pi * hz / 16000 * t).float()


MFCC_SHAPES = {
    "unaligned_rows": ((5, 4001), {}),          # every second row off 16-byte alignment
    "one_frame": ((1, 400), {}),
    "several_tiles_ragged": ((4, 16000), {}),   # 98 frames: four tiles of 24 and one of 2
    "hop_200": ((6, 4096), {"hop": 200}),
    "odd_hop": ((3, 4099), {"hop": 161}),       # frames off 8-byte alignment in shared memory
    "odd_n_mfcc": ((3, 8000), {"n_mels": 40, "n_mfcc": 13}),
}


@pytest.mark.parametrize("shape,kw", MFCC_SHAPES.values(), ids=MFCC_SHAPES.keys())
def test_mfcc_kernel_shapes(cuda, shape, kw):
    cfg = MFCCConfig(**{"n_mels": 64, "n_mfcc": 50, **kw})
    x = _noise(shape, cuda, seed=shape[1])
    got = mfcc(x, cfg)
    torch.cuda.synchronize()
    assert got.shape == (shape[0], cfg.n_frames(shape[1]), cfg.n_mfcc)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, mfcc_ref(x, cfg), rtol=1e-5, atol=2e-4)


def test_mfcc_kernel_tone(cuda):
    """Weak bins beside a strong one: the hardest input for the FFT route."""
    cfg = MFCCConfig(n_mels=64, n_mfcc=50)
    tone = _tone(cuda)
    x = torch.stack([tone, 1e-3 * tone, 0.5 * tone + 1e-4 * _noise((4096,), cuda)])
    got = mfcc(x, cfg)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, mfcc_ref(x, cfg), rtol=1e-5, atol=2e-4)


def test_mfcc_kernel_three_launches_bit_equal(cuda):
    cfg = MFCCConfig(n_mels=64, n_mfcc=50)
    x = _noise((37, 4096), cuda)
    runs = []
    for _ in range(3):
        runs.append(mfcc(x, cfg))
        torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1]) and torch.equal(runs[0], runs[2])


def test_mfcc_kernel_padded_rows_equal_plain_version(cuda):
    """All-zero rows reach the logits as padding, so they must be the plain
    version's features bit for bit, wherever they lie in the batch. The plain
    version is taken at 64 all-zero rows: at a few rows cuBLAS sums the DCT
    product in another order."""
    cfg = MFCCConfig(n_mels=64, n_mfcc=50)
    want = mfcc_ref(torch.zeros(64, 4096, device=cuda), cfg)
    assert torch.equal(want, want[:1, :1].expand_as(want))
    x = _noise((37, 4096), cuda)
    x[[0, 5, 36]] = 0.0
    got = mfcc(x, cfg)
    torch.cuda.synchronize()
    for row in (0, 5, 36):
        assert torch.equal(got[row], want[0]), row
    assert torch.equal(mfcc(torch.zeros(64, 4096, device=cuda), cfg), want)


def test_mfcc_bytes_floor_launches_and_counts_nothing(cuda):
    cfg = MFCCConfig(n_mels=64, n_mfcc=50)
    x = _noise((37, 4096), cuda)
    before = LAUNCHES[tmfcc_kernel.NAME]
    out = tmfcc_kernel.launch_bytes_floor(x, cfg)
    torch.cuda.synchronize()
    assert out.shape == (37, 24, 50) and LAUNCHES[tmfcc_kernel.NAME] == before
    smem, blocks = tmfcc_kernel.occupancy(cfg)
    assert 0 < smem <= 232448 and blocks >= 1


def test_mfcc_kernel_refuses_bad_input(cuda):
    cfg = MFCCConfig()
    x = torch.zeros(4, 800, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        tmfcc_kernel.mfcc_kernel(x.double(), cfg)
    with pytest.raises(ValueError, match="contiguous"):
        tmfcc_kernel.mfcc_kernel(x.t().contiguous().t(), cfg)
    with pytest.raises(ValueError, match="too short"):
        tmfcc_kernel.mfcc_kernel(x[:, :399].contiguous(), cfg)
