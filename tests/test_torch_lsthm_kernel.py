"""The recurrence kernel's contract on the CPU: the port's plain version
``lsthm_onlysp_recurrence_bidir_ref`` against three JAX functions, at
T = 9, H = 128, B in {1, 3}, on the inputs ``tests/test_pallas_lsthm.py``
builds. The Pallas kernels run in interpret mode. Tolerance rtol 1e-5,
atol 1e-5 (f32 on both sides, nine steps). Then the wrapper's arithmetic
that needs no card: how a batch is tiled over thread-block clusters."""

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


@pytest.mark.parametrize("max_clusters", [2, 7, 8, 16])
@pytest.mark.parametrize("B", [1, 8, 9, 31, 33, 80])
def test_choose_tiling(B, max_clusters):
    """Every row is in one tile, no tile is empty, the tile height is a
    compiled one, and no other height runs the call in fewer waves of
    resident clusters, or in as few with fewer rows a cluster."""
    rows, tiles = tlsthm.choose_tiling(B, max_clusters)
    assert rows in tlsthm.TILE_ROWS
    assert (tiles - 1) * rows < B <= tiles * rows
    waves = lambda r: -(-2 * -(-B // r) // max_clusters)
    for other in tlsthm.TILE_ROWS:
        assert (waves(rows), rows) <= (waves(other), other)
    if B <= max(tlsthm.TILE_ROWS) * (max_clusters // 2):
        assert 2 * tiles <= max_clusters  # both directions resident at once


def test_choose_tiling_at_the_eval_shape():
    """B = 31 on a card that holds 7 clusters of 16 (an H100 with 132 SMs):
    8 rows would need 8 clusters, so 12 rows on 3 tiles a direction."""
    assert tlsthm.choose_tiling(31, 7) == (12, 3)
    assert tlsthm.choose_tiling(31, 8) == (8, 4)
    assert tlsthm.choose_tiling(80, 7) == (12, 7)  # 14 clusters, two full waves


@pytest.mark.parametrize("B,max_clusters", [(0, 7), (4, 0)])
def test_choose_tiling_rejects(B, max_clusters):
    with pytest.raises(ValueError, match="no tiling"):
        tlsthm.choose_tiling(B, max_clusters)


def test_cluster_constants_match_the_kernel_source():
    """The wrapper's cluster size and tile heights are the kernel's."""
    import re
    from ser_tpu_torch.ops.kernels.build import CSRC

    src = (CSRC / f"{tlsthm.NAME}.cu").read_text()
    assert int(re.search(r"constexpr int C = (\d+);", src).group(1)) == tlsthm.CLUSTER
    cases = [int(c) for c in re.findall(r"case (\d+): return \(int\)f\(", src)]
    assert tuple(cases) == tlsthm.TILE_ROWS
    # the step loop reads no weight from device memory: K_l, K_a and gWhh
    # appear only in the gather before it
    loop = src[src.index("for (int t = 0; t < T; ++t) {"):src.index("// The exchanges of")]
    assert not re.search(r"\b(Kl|Ka|gWhh)\b\s*[\[+]", loop)
