"""The recurrence kernel's contract on the CPU: the port's plain version
``lsthm_onlysp_recurrence_bidir_ref`` against three JAX functions, at
T = 9, H = 128, B in {1, 3}, on the inputs ``tests/test_pallas_lsthm.py``
builds. The Pallas kernels run in interpret mode. Tolerance rtol 1e-5,
atol 1e-5 (f32 on both sides, nine steps)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ser_tpu.models.marn_onlysp import _eval_step
from ser_tpu.ops.pallas.lsthm import (lsthm_onlysp_recurrence_bidir,
                                      lsthm_onlysp_recurrence_bidir_stacked)
from ser_tpu_torch.ops.kernels import LAUNCHES
from ser_tpu_torch.ops.kernels import lsthm as tlsthm

T, H = 9, 128


def _inputs(B):
    rng = np.random.default_rng(11)
    f = lambda *s: (rng.standard_normal(s) * 0.1).astype(np.float32)
    sp = rng.integers(0, 2, size=(T, 2, B))
    qm = np.zeros((T, 2, B, 2), np.float32)
    qm[np.arange(T)[:, None, None], np.arange(2)[None, :, None],
       np.arange(B)[None, None, :], sp] = 1
    qm[T - 2:, :, 0] = 0.0  # a padded tail on row 0: all-zero qmask
    seqs = (f(T, 2, B, 4 * H), f(T, 2, B, 4 * H), f(T, 2, B, 3 * H), qm)
    consts = (f(2, 3 * H, 4 * H), f(2, 4 * H), f(2, 3 * H, 4 * H),
              f(2, 4 * H), f(2, H, 3 * H), f(2, 3 * H), f(2, H), f(2, H))
    return seqs, consts


def _scan(seqs, consts):
    B = seqs[0].shape[2]
    init = tuple(jnp.zeros((2, B, H)) for _ in range(5)) + (
        jnp.zeros((2, B, 2, H)),)
    _, ys = jax.lax.scan(
        lambda c, xs: jax.vmap(_eval_step, in_axes=(0, 0, 0))(consts, c, xs),
        init, seqs)
    return ys


ORACLES = {
    "pallas_bidir": lambda s, c: lsthm_onlysp_recurrence_bidir(s, c, interpret=True),
    "pallas_stacked": lambda s, c: lsthm_onlysp_recurrence_bidir_stacked(
        s, c, interpret=True),
    "vmapped_scan": _scan,
}


@pytest.mark.parametrize("oracle", sorted(ORACLES))
@pytest.mark.parametrize("B", [1, 3])
def test_ref_matches_jax(B, oracle):
    seqs, consts = _inputs(B)
    ref = ORACLES[oracle](tuple(map(jnp.asarray, seqs)),
                          tuple(map(jnp.asarray, consts)))
    before = LAUNCHES[tlsthm.NAME]
    got = tlsthm.lsthm_onlysp_recurrence_bidir(
        tuple(map(torch.from_numpy, seqs)), tuple(map(torch.from_numpy, consts)))
    assert LAUNCHES[tlsthm.NAME] == before  # a CPU tensor takes the plain version
    assert got.shape == (T, 2, B, 4 * H)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_kernel_wrapper_rejects_bad_inputs():
    """The launch path checks shapes and dtypes before touching a pointer."""
    seqs, consts = _inputs(1)
    seqs = tuple(map(torch.from_numpy, seqs))
    consts = tuple(map(torch.from_numpy, consts))
    tlsthm._check(seqs, consts)
    with pytest.raises(ValueError, match="shape"):
        tlsthm._check(seqs, (consts[0][:, :-1],) + consts[1:])
    with pytest.raises(ValueError, match="dtype"):
        tlsthm._check((seqs[0].double(),) + seqs[1:], consts)
    with pytest.raises(ValueError, match="contiguous"):
        tlsthm._check(seqs, consts[:4] + (consts[4].transpose(1, 2).contiguous()
                                          .transpose(1, 2),) + consts[5:])
