"""The recurrence kernel's contract on the CPU: the port's plain version
``lsthm_onlysp_recurrence_bidir_ref`` against three JAX functions, at
T = 9, H = 128, B in {1, 3}, on the inputs ``tests/test_pallas_lsthm.py``
builds. The Pallas kernels run in interpret mode. Tolerance rtol 1e-5,
atol 1e-5 (f32 on both sides, nine steps). At P = 9 (MELD), which the
Pallas kernels do not take, against the JAX package's vmapped scan, with a
row padded from the start and an all-zero qmask row mid-sequence. Then the
wrapper's arithmetic that needs no card: how a batch is tiled over
thread-block clusters, and the party counts it takes."""

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


def _inputs(B, P=2):
    rng = np.random.default_rng(11)
    f = lambda *s: (rng.standard_normal(s) * 0.1).astype(np.float32)
    sp = rng.integers(0, P, size=(T, 2, B))
    qm = np.zeros((T, 2, B, P), np.float32)
    qm[np.arange(T)[:, None, None], np.arange(2)[None, :, None],
       np.arange(B)[None, None, :], sp] = 1
    qm[T - 2:, :, 0] = 0.0  # a padded tail on row 0: all-zero qmask
    seqs = (f(T, 2, B, 4 * H), f(T, 2, B, 4 * H), f(T, 2, B, 3 * H), qm)
    consts = (f(2, 3 * H, 4 * H), f(2, 4 * H), f(2, 3 * H, 4 * H),
              f(2, 4 * H), f(2, H, 3 * H), f(2, 3 * H), f(2, H), f(2, H))
    return seqs, consts


def _scan(seqs, consts):
    B, P = seqs[3].shape[2:]
    init = tuple(jnp.zeros((2, B, H)) for _ in range(5)) + (
        jnp.zeros((2, B, P, H)),)
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


@pytest.mark.parametrize("B", [1, 3])
def test_ref_matches_jax_at_nine_parties(B):
    seqs, consts = _inputs(B, P=9)
    seqs[3][:, :, B - 1] = 0.0  # the last row padded at every step
    seqs[3][4, 1, 0] = 0.0  # an all-zero qmask mid-sequence: party 0, no scatter
    ref = _scan(tuple(map(jnp.asarray, seqs)), tuple(map(jnp.asarray, consts)))
    before = LAUNCHES[tlsthm.NAME]
    got = tlsthm.lsthm_onlysp_recurrence_bidir(
        tuple(map(torch.from_numpy, seqs)), tuple(map(torch.from_numpy, consts)))
    assert LAUNCHES[tlsthm.NAME] == before
    assert got.shape == (T, 2, B, 4 * H) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("P", [1, 3, 8])
def test_kernel_wrapper_refuses_uncompiled_party_counts(P):
    """A qmask whose P the kernel was not compiled for raises and names the
    compiled ones; nothing falls back to the plain loop."""
    seqs, consts = _inputs(2, P=P)
    with pytest.raises(ValueError, match=rf"qmask has {P} parties; the kernel is "
                                         r"compiled for P in \(2, 9\)"):
        tlsthm._check(tuple(map(torch.from_numpy, seqs)),
                      tuple(map(torch.from_numpy, consts)))


@pytest.mark.parametrize("P", tlsthm.PARTIES)
def test_kernel_wrapper_takes_compiled_party_counts(P):
    seqs, consts = _inputs(2, P=P)
    tlsthm._check(tuple(map(torch.from_numpy, seqs)), tuple(map(torch.from_numpy, consts)))


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
    parties = [int(c) for c in re.findall(r"if \(parties == (\d+)\) return for_rows", src)]
    assert tuple(parties) == tlsthm.PARTIES
    # the step loop reads no weight from device memory: K_l, K_a and gWhh
    # appear only in the gather before it
    loop = src[src.index("for (int t = 0; t < T; ++t) {"):src.index("// The exchanges of")]
    assert not re.search(r"\b(Kl|Ka|gWhh)\b\s*[\[+]", loop)


def test_ptxas_summary_tells_the_party_instantiations_apart():
    """``chip_smoke.py`` reads registers and spills of every instantiation,
    (rows / 4, parties), from ``nvcc -Xptxas -v``; it fails on a spill."""
    import chip_smoke

    log = "".join(
        f"ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_127lsthm_onlysp_"
        f"cluster_kernelILi{rq}ELi{p}EEEvPKfS2_S2_S2_' for 'sm_90a'\n"
        f"ptxas info    : Function properties for x\n    {spill} bytes stack frame, "
        f"{spill} bytes spill stores, {spill} bytes spill loads\n"
        f"ptxas info    : Used {regs} registers\n"
        for rq, p, regs, spill in ((4, 9, 219, 0), (4, 2, 194, 8)))
    assert chip_smoke.ptxas_summary(log) == [
        "lsthm_onlysp_cluster_kernelILi4ELi9E: 219 registers, spill stores 0 B, loads 0 B",
        "lsthm_onlysp_cluster_kernelILi4ELi2E: 194 registers, spill stores 8 B, loads 8 B"]


def test_recurrence_bound_counts_the_party_work():
    """The bound's operations at P parties: the P = 2 products plus the
    scatter of P party memories of H units, 3 flops each, and P - 1
    compares to select a row's party."""
    import chip_smoke

    bounds, B = {}, 64  # a batch at which the operations bound the call
    for P in (2, 9):
        seqs, consts = map(lambda ts: tuple(map(torch.from_numpy, ts)), _inputs(B, P=P))
        out = torch.zeros(T, 2, B, 4 * H)
        bounds[P] = chip_smoke.recurrence_bound(seqs, consts, out)
    assert bounds[2][1] == bounds[9][1] == "operations"
    extra_flops = T * 2 * B * (3 * H * (9 - 2) + (9 - 1) - (2 - 1))
    np.testing.assert_allclose((bounds[9][0] - bounds[2][0]) * 1e-3 * chip_smoke.F32_PEAK,
                               extra_flops, rtol=1e-9)


def test_build_returns_the_kept_log_of_a_built_source(tmp_path, monkeypatch):
    """A source built before is not compiled again (no nvcc here), and its
    nvcc output, kept beside the library, still reaches ``chip_smoke.py``'s
    register and spill report."""
    from ser_tpu_torch.ops.kernels import build

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    so = build.library_path(tlsthm.NAME)
    so.write_bytes(b"")
    so.with_suffix(".log").write_text("ptxas info    : Used 219 registers")
    assert build.build([tlsthm.NAME]) == {tlsthm.NAME: "ptxas info    : Used 219 registers"}
