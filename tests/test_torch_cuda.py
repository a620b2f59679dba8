"""The recurrence kernel on the card (marker ``cuda``; skips without CUDA).

Imports no JAX, so it also runs on a machine with the card and no JAX:
``python -m pytest tests/test_torch_cuda.py -m cuda --noconftest``.
Tolerance atol 1e-4: the kernel sums in another order than the plain
version over T serial steps.
"""

import numpy as np
import pytest
import torch

from ser_tpu_torch.device import disable_tf32
from ser_tpu_torch.ops.kernels import LAUNCHES
from ser_tpu_torch.ops.kernels import lsthm as tlsthm

pytestmark = pytest.mark.cuda
H = 128


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; runs on the card")
    disable_tf32()
    return torch.device("cuda")


def _inputs(T, B, dev):
    rng = np.random.default_rng(B)
    f = lambda *s: torch.from_numpy(
        (0.1 * rng.standard_normal(s)).astype(np.float32)).to(dev)
    qm = np.eye(2, dtype=np.float32)[rng.integers(0, 2, size=(T, 2, B))]
    qm[T // 2:, :, 0] = 0.0  # padded tail on row 0
    seqs = (f(T, 2, B, 4 * H), f(T, 2, B, 4 * H), f(T, 2, B, 3 * H),
            torch.from_numpy(qm).to(dev))
    consts = (f(2, 3 * H, 4 * H), f(2, 4 * H), f(2, 3 * H, 4 * H),
              f(2, 4 * H), f(2, H, 3 * H), f(2, 3 * H), f(2, H), f(2, H))
    return seqs, consts


@pytest.mark.parametrize("B", [1, 9, 31])
def test_kernel_matches_plain_version(cuda, B):
    seqs, consts = _inputs(20, B, cuda)
    before = LAUNCHES[tlsthm.NAME]
    got = tlsthm.lsthm_onlysp_recurrence_bidir(seqs, consts)
    torch.cuda.synchronize()
    assert LAUNCHES[tlsthm.NAME] == before + 1
    want = tlsthm.lsthm_onlysp_recurrence_bidir_ref(seqs, consts)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def test_kernel_refuses_mixed_devices(cuda):
    seqs, consts = _inputs(3, 2, cuda)
    with pytest.raises(ValueError, match="xl_proj on"):
        tlsthm.lsthm_onlysp_recurrence_bidir(seqs, (consts[0].cpu(),) + consts[1:])
