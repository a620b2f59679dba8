"""The CUDA kernels on the card (marker ``cuda``; skips without CUDA).

Imports no JAX, so it also runs on a machine with the card and no JAX:
``python -m pytest tests/test_torch_cuda.py -m cuda --noconftest``.
Tolerances: the recurrence atol 1e-4 (another summation order over T serial
steps), at 2 and 9 parties; the MFCC kernel rtol 1e-5, atol 2e-4 (its spectrum comes from an FFT
with the window applied first, the plain version's from dense products with
the window folded into the DFT matrices; then 64-term DCT sums of values up
to |log 1e-6| = 13.8); the rank-1 attention kernel |Δ| <= 1e-5 + 1e-4·|plain|
for z, dx1, dx2 and <= 1e-5·max|plain| + 1e-4·|plain| for dwq, dwk, which sum
B·128 terms (128-term sums in another order, f32); a train step card against
CPU with dropout off: the loss at rtol 1e-5, every gradient within 1e-3 of
its tensor's largest plus 1e-6 of the step's largest (``tests/
test_torch_train_step.py``'s contract against the JAX package). mf, la and
newz, which run no kernel of the port: a request and a train step card
against CPU with every kernel counter unmoved, and ``NewZStream`` on the card
against its causal batch forward and the CPU stream (rtol 1e-4, atol 1e-5).
DialogueRNN, BiLSTM, MARN, MARN_AT and MARN_ATV the same way (a request's
valid rows, at 2 and 9 parties), and DialogueRNN's wav request, which
launches the MFCC kernel once. MARN1_onlysp under each zoo
``--encoder_attention`` kind (a request, the recurrence kernel once, with the
op's weights drawn large enough to move the log-probs past the tolerance),
and a muse step with ``--infonce`` (the train contract, 2T rank-1 launches).
The train step as a CUDA graph (``train/step_graph.py``), dropout off unless
said: onlysp and the eight ``fused_directions`` variants at [110, 80], [109,
40], [110, 80] (two captures and a replay) against an eager trainer with the
same Adam, each step's loss at rtol 1e-5 and gradients within the train
contract; each returned loss its own; replays drawing fresh ``Dropout`` and
rank-1 masks at their rates (6 binomial sigmas); a reload of the weights and
the optimizer's first state, and a resume of a train state, continuing as
eager steps do.
"""

import numpy as np
import pytest
import torch

from ser_tpu_torch.data.loaders import get_loaders
from ser_tpu_torch.data.synthetic import generate_iemocap_pickles, synthetic_batch
from ser_tpu_torch.device import disable_tf32
from ser_tpu_torch.ops.kernels import LAUNCHES
from ser_tpu_torch.ops.kernels import lsthm as tlsthm
from ser_tpu_torch.ops.kernels import mfcc as tmfcc_kernel
from ser_tpu_torch.ops.kernels import rank1 as trank1
from ser_tpu_torch.ops.layers import Dropout
from ser_tpu_torch.ops.mfcc import MFCCConfig, mfcc, mfcc_ref
from ser_tpu_torch.train.trainer import ModelTrainer

pytestmark = pytest.mark.cuda
H = 128


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; runs on the card")
    disable_tf32()
    return torch.device("cuda")


def _inputs(T, B, dev, padded_row=None, P=2):
    rng = np.random.default_rng(B)
    f = lambda *s: torch.from_numpy(
        (0.1 * rng.standard_normal(s)).astype(np.float32)).to(dev)
    qm = np.eye(P, dtype=np.float32)[rng.integers(0, P, size=(T, 2, B))]
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


@pytest.mark.parametrize("B", [1, 16, 80])
def test_kernel_nine_parties_matches_plain_version(cuda, B):
    """P = 9 (MELD): party products and memories of 9 parties in registers,
    argmax with the first index winning."""
    seqs, consts = _inputs(24, B, cuda, P=9)
    before = LAUNCHES[tlsthm.NAME]
    got = tlsthm.lsthm_onlysp_recurrence_bidir(seqs, consts)
    torch.cuda.synchronize()
    assert LAUNCHES[tlsthm.NAME] == before + 1
    want = tlsthm.lsthm_onlysp_recurrence_bidir_ref(seqs, consts)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def test_kernel_nine_parties_padded_and_all_zero_rows(cuda):
    seqs, consts = _inputs(24, 16, cuda, padded_row=5, P=9)
    seqs[3][3:7, :, 9] = 0.0  # an all-zero qmask mid-sequence: party 0, no scatter
    got = tlsthm.lsthm_onlysp_recurrence_bidir(seqs, consts)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    want = tlsthm.lsthm_onlysp_recurrence_bidir_ref(seqs, consts)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def test_kernel_nine_parties_two_runs_bit_equal(cuda):
    seqs, consts = _inputs(40, 80, cuda, P=9)
    runs = []
    for _ in range(2):
        runs.append(tlsthm.lsthm_onlysp_recurrence_bidir(seqs, consts))
        torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1])


@pytest.mark.parametrize("P", [3, 8])
def test_kernel_refuses_uncompiled_parties(cuda, P):
    seqs, consts = _inputs(4, 2, cuda, P=P)
    before = LAUNCHES[tlsthm.NAME]
    with pytest.raises(ValueError, match=rf"{P} parties; the kernel is compiled"):
        tlsthm.lsthm_onlysp_recurrence_bidir(seqs, consts)
    assert LAUNCHES[tlsthm.NAME] == before


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


def _rank1_inputs(B, dev, seed=0):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    return (t(2.0 * rng.standard_normal((2, B, H))), t(0.5 * rng.standard_normal((2, B, H))),
            t(1.0 + 0.1 * rng.standard_normal((2, H))),
            t(1.0 + 0.3 * rng.standard_normal((2, H))),
            t(rng.standard_normal((2, B, H))))


def _rank1_run(fn, ins, g, seed, step, p):
    xs = [x.clone().requires_grad_() for x in ins]
    z = fn(*xs, seed, step, p)
    grads = torch.autograd.grad(z, xs, g)
    torch.cuda.synchronize()
    return (z.detach(), *grads)


@pytest.mark.parametrize("B", [1, 31, 80, 97, 256])
@pytest.mark.parametrize("p", [0.0, 0.2])
def test_rank1_kernel_matches_plain_version(cuda, B, p):
    *ins, g = _rank1_inputs(B, cuda, seed=B)
    seed = torch.tensor([123456789], dtype=torch.int32, device=cuda)
    before = LAUNCHES[trank1.NAME]
    got = _rank1_run(trank1.rank1_attention, ins, g, seed, 5, p)
    assert LAUNCHES[trank1.NAME] == before + 2  # forward and backward
    want = _rank1_run(trank1.rank1_attention_ref, ins, g, seed, 5, p)
    for name, a, b in zip(("z", "dx1", "dx2", "dwq", "dwk"), got, want):
        assert a.shape == b.shape and torch.isfinite(a).all(), name
        atol = 1e-5 * (b.abs().max().item() if name in ("dwq", "dwk") else 1.0)
        assert ((a - b).abs() <= atol + 1e-4 * b.abs()).all(), name


@pytest.mark.parametrize("B", [80, 256])
def test_rank1_kernel_three_runs_bit_equal(cuda, B):
    """dwq and dwk are summed over b by the last block to take a ticket: the
    sum must not depend on which block that is."""
    *ins, g = _rank1_inputs(B, cuda, seed=3)
    seed = torch.tensor([42], dtype=torch.int32, device=cuda)
    runs = [_rank1_run(trank1.rank1_attention, ins, g, seed, 9, 0.2) for _ in range(3)]
    for a, b, c in zip(*runs):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_rank1_kernel_one_cuda_kernel_each_way(cuda):
    """Under the profiler, a forward and a backward are one CUDA kernel
    each: no row-sum kernel, no fill, no copy. The call is traced between
    two marker kernels inside padding calls, as ``chip_smoke.py`` counts
    launches: the tracer has been seen to lose the records at the edges of
    a short window. A trace that lost a marker is taken again."""
    from torch.profiler import ProfilerActivity, profile

    *ins, g = _rank1_inputs(80, cuda, seed=4)
    seed = torch.tensor([5], dtype=torch.int32, device=cuda)
    kernel = trank1.Rank1Kernel(ins[2], ins[3], seed, 0.2)
    kernel.backward(ins[0], ins[1], 0, g)  # the scratch is made on first use
    marker = torch.zeros(1, device=cuda)
    torch.cuda.synchronize()
    for run, want in ((lambda: kernel.forward(ins[0], ins[1], 1), "rank1_fwd_kernel"),
                      (lambda: kernel.backward(ins[0], ins[1], 1, g), "rank1_bwd_kernel")):
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for calls in (20, 0, 1, 0, 20):
                    for _ in range(calls):
                        run()
                    if not calls:
                        marker.add_(1)
                torch.cuda.synchronize()
            events = sorted((e for e in prof.events()
                             if e.device_type == torch.autograd.DeviceType.CUDA),
                            key=lambda e: e.time_range.start)
            marks = [i for i, e in enumerate(events) if "elementwise" in e.name]
            if len(marks) == 2:
                break
        assert len(marks) == 2, "every trace lost a marker kernel"
        names = [e.name for e in events[marks[0] + 1:marks[1]]]
        assert len(names) == 1 and want in names[0], names


def test_rank1_kernel_keeps_one_minus_p(cuda):
    """With wk = 0 every e is 1 and x2 = 1, so z = kept / ((1 - p) D): the
    kernel's own mask, counted over 2.6 M draws, and equal to the plain
    version's count."""
    B, p = 80, 0.2
    seed = torch.tensor([7], dtype=torch.int32, device=cuda)
    x1 = torch.randn(2, B, H, device=cuda)
    ones = torch.ones(2, B, H, device=cuda)
    zero_w = torch.zeros(2, H, device=cuda)
    z = trank1.rank1_attention(x1, ones, torch.ones(2, H, device=cuda), zero_w, seed, 0, p)
    kept = (z * (1 - p) * H).round().sum().item()
    draws = 2 * B * H * H
    assert abs(kept / draws - (1 - p)) <= 0.002
    assert kept == trank1.keep_mask(seed, 0, B, p).sum().item()


def test_rank1_kernel_refuses_bad_input(cuda):
    *ins, g = _rank1_inputs(4, cuda)
    seed = torch.tensor([1], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="seed"):
        trank1.rank1_attention(*ins, seed.cpu(), 0, 0.2)
    with pytest.raises(ValueError, match="x2"):
        trank1.rank1_attention(ins[0], ins[1].double(), *ins[2:], seed, 0, 0.2)
    with pytest.raises(ValueError, match="wk"):
        trank1.bind(ins[2], ins[3][:, :64].contiguous(), seed, 0.2)
    # what only the per-call binding sees: x1, x2 and g at each step
    kernel = trank1.bind(ins[2], ins[3], seed, 0.2)
    x1, x2 = ins[:2]
    for bad, match in ((x1.double(), "x1"), (x1[:, :3].contiguous(), "x2"),
                       (x1.cpu(), "x1 on cpu"),
                       (x1.transpose(1, 2).contiguous().transpose(1, 2), "not contiguous"),
                       (x1[:1].contiguous(), r"\[2, B>=1, 128\]")):
        with pytest.raises(ValueError, match=match):
            kernel(bad, x2, 0)
    with pytest.raises(ValueError, match="x2 on cpu"):
        kernel(x1, x2.cpu(), 0)
    with pytest.raises(ValueError, match="g: torch.float64"):
        kernel.backward(x1, x2, 0, g.double())
    with pytest.raises(ValueError, match="g is not contiguous"):
        kernel.backward(x1, x2, 0, g.transpose(1, 2).contiguous().transpose(1, 2))


def _no_dropout(model):
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    model.dropout_rate = model.attn_dropout = 0.0


def _randomize_constants(models, seed=1):
    """Seeded random values for the parameters the reference initialises to
    a constant (as ``chip_smoke.py`` does: with them the head's sequence
    attentions work on rounding noise, and so do their gradients)."""
    g = torch.Generator().manual_seed(seed)
    new = {}
    for name, p in models[0].named_parameters():
        if p.numel() == 1 or p.detach().std().item() == 0:
            new[name] = (torch.randn(p.shape, generator=g) / p.shape[0] ** 0.5
                         if p.ndim == 2 and p.shape[0] > 1
                         else p.detach().cpu() + 0.1 * torch.randn(p.shape, generator=g))
    with torch.no_grad():
        for model in models:
            params = dict(model.named_parameters())
            for name, value in new.items():
                params[name].copy_(value.to(params[name].device))


def test_train_step_card_matches_cpu(cuda):
    batch = synthetic_batch(L=16, B=4, seed=2, min_len=6)
    trainers = {d: ModelTrainer(device=d, seed=3) for d in ("cpu", "cuda")}
    _randomize_constants([t.model for t in trainers.values()])
    before = LAUNCHES[trank1.NAME]
    losses = {}
    for d, t in trainers.items():
        _no_dropout(t.model)
        losses[d] = t._train_step_impl(batch, 1e-3).item()
    assert LAUNCHES[trank1.NAME] == before + 2 * 16  # T forward, T backward
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-5)
    cpu = dict(trainers["cpu"].model.named_parameters())
    card = dict(trainers["cuda"].model.named_parameters())
    top = max(p.grad.abs().max().item() for p in cpu.values() if p.grad is not None)
    for name, p in cpu.items():
        q = card[name]
        assert (p.grad is None) == (q.grad is None), name
        if p.grad is not None:
            tol = 1e-3 * p.grad.abs().max().item() + 1e-6 * top
            assert (q.grad.cpu() - p.grad).abs().max().item() <= tol, name
        assert (q.detach().cpu() - p.detach()).abs().max().item() <= 2.05e-3, name


def test_trainer_eval_launches_the_recurrence_kernel(cuda, tmp_path):
    feature_path = generate_iemocap_pickles(str(tmp_path), n_train=8, n_test=6,
                                            min_len=4, max_len=12, seed=1)
    _, _, test_loader = get_loaders(feature_path, batch_size=4)
    trainer = ModelTrainer(seed=0, res_csv_path=str(tmp_path / "res.csv"))
    assert trainer.device.type == "cuda"
    before = LAUNCHES[tlsthm.NAME]
    acc, f1, extras = trainer.eval_network(test_loader)
    assert LAUNCHES[tlsthm.NAME] == before + len(test_loader) == before + 2
    assert 0 <= acc <= 100 and 0 <= f1 <= 100 and extras == {}
    assert (tmp_path / "res.csv").exists()


def test_meld_request_launches_the_recurrence_kernel(cuda):
    """A 9-party request through ``Predictor`` on the card runs the kernel
    once and agrees with the CPU (which runs the plain loop) at rtol 1e-3,
    atol 1e-4."""
    from ser_tpu_torch.models.registry import get_model_spec
    from ser_tpu_torch.serving import Predictor

    batch = synthetic_batch(L=20, B=6, n_classes=7, seed=3, d_audio=300,
                            d_visual=600, n_parties=9)
    x, qmask, umask = get_model_spec("MARN1_onlysp").make_inputs(batch)
    gpu = Predictor(seed=0, n_classes=7)
    cpu = Predictor(state_dict={k: v.cpu() for k, v in gpu.model.state_dict().items()},
                    device="cpu", n_classes=7)
    before = LAUNCHES[tlsthm.NAME]
    logp = gpu.predict(x, qmask, umask)[0]
    torch.cuda.synchronize()
    assert LAUNCHES[tlsthm.NAME] == before + 1
    torch.testing.assert_close(logp.cpu(), cpu.predict(x, qmask, umask)[0],
                               rtol=1e-3, atol=1e-4)


VARIANTS = ("MARN1_sp", "MARN1_cf", "MARN1_azs", "MARN1_sps", "MARN1_nsps", "MARN1_no_en")


@pytest.mark.parametrize("P", [2, 9])
@pytest.mark.parametrize("name", VARIANTS)
def test_variant_request_launches_rank1_a_step_and_matches_cpu(cuda, name, P):
    """A rank-1 MARN1 variant's request on the card launches the rank-1
    kernel once a step (both directions in one launch) and no recurrence
    kernel, and agrees with the CPU, which runs the plain version, at rtol
    1e-3, atol 1e-4."""
    from ser_tpu_torch.models.registry import get_model_spec
    from ser_tpu_torch.serving import Predictor

    T, B = 20, 6
    meld = dict(n_classes=7, d_audio=300, d_visual=600, n_parties=9) if P == 9 else {}
    batch = synthetic_batch(L=T, B=B, seed=3, min_len=5, **meld)
    x, qmask, umask = get_model_spec(name).make_inputs(batch)
    gpu = Predictor(name, seed=0, n_classes=7 if P == 9 else 6)
    cpu = Predictor(name, state_dict={k: v.cpu() for k, v in gpu.model.state_dict().items()},
                    device="cpu", n_classes=7 if P == 9 else 6)
    before = dict(LAUNCHES)
    logp = gpu.predict(x, qmask, umask)[0]
    torch.cuda.synchronize()
    assert LAUNCHES[trank1.NAME] == before.get(trank1.NAME, 0) + T
    assert LAUNCHES[tlsthm.NAME] == before.get(tlsthm.NAME, 0)
    torch.testing.assert_close(logp.cpu(), cpu.predict(x, qmask, umask)[0],
                               rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("name", VARIANTS)
def test_variant_train_step_card_matches_cpu(cuda, name):
    T = 16
    batch = synthetic_batch(L=T, B=4, seed=2, min_len=6)
    trainers = {d: ModelTrainer(device=d, model=name, seed=3) for d in ("cpu", "cuda")}
    _randomize_constants([t.model for t in trainers.values()])
    before = LAUNCHES[trank1.NAME]
    losses = {}
    for d, t in trainers.items():
        _no_dropout(t.model)
        losses[d] = t._train_step_impl(batch, 1e-3).item()
    # T forward, T backward; nsps and no_en leave z out of a step's output,
    # so the last step's z reaches no loss and has no backward
    assert LAUNCHES[trank1.NAME] == before + 2 * T - (name in ("MARN1_nsps", "MARN1_no_en"))
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-5)
    cpu = dict(trainers["cpu"].model.named_parameters())
    card = dict(trainers["cuda"].model.named_parameters())
    top = max(p.grad.abs().max().item() for p in cpu.values() if p.grad is not None)
    for pname, p in cpu.items():
        q = card[pname]
        assert (p.grad is None) == (q.grad is None), pname
        if p.grad is not None:
            tol = 1e-3 * p.grad.abs().max().item() + 1e-6 * top
            assert (q.grad.cpu() - p.grad).abs().max().item() <= tol, pname
        assert (q.detach().cpu() - p.detach()).abs().max().item() <= 2.05e-3, pname


REST = ("MARN1_mf", "MARN1_la", "MARN1_newz")


@pytest.mark.parametrize("name,P", [(n, 2) for n in REST] + [("MARN1_mf", 9), ("MARN1_newz", 9)])
def test_rest_request_launches_no_port_kernel_and_matches_cpu(cuda, name, P):
    """mf, la and newz run no kernel of the port (no rank-1 attention, no
    recurrence kernel, and the audio slot they never read); a request on the
    card agrees with the CPU at rtol 1e-3, atol 1e-4."""
    from ser_tpu_torch.models.registry import get_model_spec
    from ser_tpu_torch.serving import Predictor

    meld = dict(n_classes=7, d_audio=300, d_visual=600, n_parties=9) if P == 9 else {}
    batch = synthetic_batch(L=20, B=6, seed=3, min_len=5, **meld)
    x, qmask, umask = get_model_spec(name).make_inputs(batch)
    gpu = Predictor(name, seed=0, n_classes=7 if P == 9 else 6)
    cpu = Predictor(name, state_dict={k: v.cpu() for k, v in gpu.model.state_dict().items()},
                    device="cpu", n_classes=7 if P == 9 else 6)
    before = dict(LAUNCHES)
    out = gpu.predict(x, qmask, umask)[0]
    torch.cuda.synchronize()
    assert dict(LAUNCHES) == before
    torch.testing.assert_close(out.cpu(), cpu.predict(x, qmask, umask)[0],
                               rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("name", REST)
def test_rest_train_step_card_matches_cpu(cuda, name):
    _step_card_matches_cpu_no_port_kernel(name)


def _step_card_matches_cpu_no_port_kernel(name):
    """One step of ``name`` at [16, 4], card against CPU (dropout off,
    constants made random): no port kernel, the loss, the gradients, the
    dead set and the update to the train contract."""
    batch = synthetic_batch(L=16, B=4, seed=2, min_len=6)
    trainers = {d: ModelTrainer(device=d, model=name, seed=3) for d in ("cpu", "cuda")}
    _randomize_constants([t.model for t in trainers.values()])
    before = dict(LAUNCHES)
    losses = {}
    for d, t in trainers.items():
        _no_dropout(t.model)
        losses[d] = t._train_step_impl(batch, 1e-3).item()
    assert dict(LAUNCHES) == before
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-5)
    cpu = dict(trainers["cpu"].model.named_parameters())
    card = dict(trainers["cuda"].model.named_parameters())
    top = max(p.grad.abs().max().item() for p in cpu.values() if p.grad is not None)
    for pname, p in cpu.items():
        q = card[pname]
        assert (p.grad is None) == (q.grad is None), pname
        if p.grad is not None:
            tol = 1e-3 * p.grad.abs().max().item() + 1e-6 * top
            assert (q.grad.cpu() - p.grad).abs().max().item() <= tol, pname
        assert (q.detach().cpu() - p.detach()).abs().max().item() <= 2.05e-3, pname


def test_newz_stream_on_card_matches_causal_forward_and_cpu(cuda):
    """``NewZStream`` on the card against the causal batch forward on the
    card and the stream on the CPU, at rtol 1e-4, atol 1e-5."""
    from ser_tpu_torch.models.marn_newz import MARN1NewZ
    from ser_tpu_torch.ops.init import generator
    from ser_tpu_torch.streaming import NewZStream

    rng = np.random.default_rng(4)
    T = 30
    x = rng.standard_normal((T, 1124)).astype(np.float32)
    qmask = np.eye(2, dtype=np.float32)[rng.integers(0, 2, size=T)]
    model = MARN1NewZ(generator=generator(0), causal_encoder=True).eval()
    outs = {}
    for dev in ("cuda", "cpu"):
        stream = NewZStream(model.to(dev), max_len=32)
        outs[dev] = np.stack([stream.append(x[t], qmask[t]) for t in range(T)])
    with torch.inference_mode():
        batch = model.to("cuda")(torch.from_numpy(x[:, None]).cuda(),
                                 torch.from_numpy(qmask[:, None]).cuda())[0].cpu().numpy()
    np.testing.assert_allclose(outs["cuda"], batch, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(outs["cuda"], outs["cpu"], rtol=1e-4, atol=1e-5)


BASELINES = ("DialogueRNN", "BiLSTM", "MARN", "MARN_AT", "MARN_ATV")


@pytest.mark.parametrize("name,P", [(n, 2) for n in BASELINES]
                         + [(n, 9) for n in ("BiLSTM", "MARN_AT", "MARN_ATV")])
def test_baseline_request_launches_no_port_kernel_and_matches_cpu(cuda, name, P):
    """DialogueRNN, BiLSTM (cuDNN's LSTM), MARN, MARN_AT and MARN_ATV run no
    kernel of the port on a feature request; on the card it agrees with the
    CPU on the valid rows at rtol 1e-3, atol 1e-4."""
    from ser_tpu_torch.models.registry import get_model_spec
    from ser_tpu_torch.serving import Predictor

    meld = dict(n_classes=7, d_audio=300, d_visual=600, n_parties=9) if P == 9 else {}
    batch = synthetic_batch(L=20, B=6, seed=3, min_len=5, **meld)
    spec = get_model_spec(name)
    x, qmask, umask = spec.make_inputs(batch)
    gpu = Predictor(name, seed=0, n_classes=7 if P == 9 else 6)
    cpu = Predictor(name, state_dict={k: v.cpu() for k, v in gpu.model.state_dict().items()},
                    device="cpu", n_classes=7 if P == 9 else 6)
    before = dict(LAUNCHES)
    out, labels = gpu.predict(x, qmask, umask)
    torch.cuda.synchronize()
    assert dict(LAUNCHES) == before and labels.shape == umask.shape
    valid = torch.as_tensor(spec.rows(umask)) > 0
    torch.testing.assert_close(out.cpu()[valid], cpu.predict(x, qmask, umask)[0][valid],
                               rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("name", BASELINES)
def test_baseline_train_step_card_matches_cpu(cuda, name):
    _step_card_matches_cpu_no_port_kernel(name)


def test_dialogue_rnn_wav_request_launches_mfcc_once_and_matches_cpu(cuda, tmp_path):
    """DialogueRNN reads the audio slot of its trimodal input: with the MFCC
    front end a collated wav batch launches the MFCC kernel once, and the
    answer agrees with the CPU's on the valid rows."""
    from ser_tpu_torch.serving import Predictor

    feature_path = generate_iemocap_pickles(str(tmp_path), n_train=8, n_test=6,
                                            min_len=4, max_len=12, seed=1, with_wav=True)
    _, _, test_loader = get_loaders(feature_path, batch_size=6, wav_path="auto")
    batch = next(iter(test_loader))
    gpu = Predictor("DialogueRNN", seed=0, audio_frontend="mfcc")
    cpu = Predictor("DialogueRNN", state_dict={k: v.cpu() for k, v in
                                               gpu.model.state_dict().items()},
                    device="cpu", audio_frontend="mfcc")
    before = dict(LAUNCHES)
    out = gpu.predict_batch(batch)[0]
    torch.cuda.synchronize()
    launched = {k: v - before.get(k, 0) for k, v in LAUNCHES.items() if v != before.get(k, 0)}
    assert launched == {tmfcc_kernel.NAME: 1}
    valid = torch.as_tensor(batch["umask"]).reshape(-1) > 0
    torch.testing.assert_close(out.cpu()[valid], cpu.predict_batch(batch)[0][valid],
                               rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("name,dtype", [("MARN1_onlysp", "f32"), ("MARN1_onlysp", "bf16"),
                                        ("MARN1_sp", "int8"), ("BiLSTM", "bf16"),
                                        ("DialogueRNN", "f32")])
def test_serving_bucket_graph(cuda, name, dtype, tmp_path):
    """A serving artifact on the card: each bucket's CUDA graph, captured at
    its first request, launches what the eager forward launches on the
    padded batch (the recurrence kernel once for onlysp, the rank-1 kernel
    T times for sp), two replays are bit-equal, an f32 replay equals the
    eager ``Predictor`` to 1e-5 and agrees with the CPU artifact to rtol
    1e-3, atol 1e-4 on the valid rows."""
    from ser_tpu_torch.serving import GRAPH_WARMUP, Predictor, ServingModel, save_model

    gpu = Predictor(name, seed=0)
    path = str(tmp_path / "m.ser")
    save_model(path, name, {k: v.cpu() for k, v in gpu.model.state_dict().items()},
               24, [2, 8], dtype=dtype)
    served, cpu = ServingModel.load(path), ServingModel.load(path, device="cpu")
    batch = synthetic_batch(L=20, B=5, seed=4)
    before = dict(LAUNCHES)
    first = served.predict(batch)
    torch.cuda.synchronize()
    mid = dict(LAUNCHES)
    again = served.predict(batch)
    torch.cuda.synchronize()
    per_request = {k: v - mid.get(k, 0) for k, v in LAUNCHES.items() if v != mid.get(k, 0)}
    assert served.last_bucket == (24, 8)
    inputs = served.padded_inputs(batch, (24, 8))
    want = {"MARN1_onlysp": {tlsthm.NAME: 1}, "MARN1_sp": {trank1.NAME: 24}}.get(name, {})
    assert per_request == want
    assert {k: v - before.get(k, 0) for k, v in mid.items()
            if v != before.get(k, 0)} == {k: (GRAPH_WARMUP + 1) * v for k, v in want.items()}
    np.testing.assert_array_equal(first["logp"], again["logp"])
    assert np.isfinite(first["logp"]).all() and first["logp"].shape[:2] == (5, 20)
    valid = batch["umask"] > 0
    ref = cpu.predict(batch)["logp"]
    if dtype == "f32":
        eager = gpu.predict(*inputs)[0]
        replay = served.bucket_forward((24, 8), *inputs)
        assert (replay - eager).abs().max().item() <= 1e-5
        np.testing.assert_allclose(first["logp"][valid], ref[valid], rtol=1e-3, atol=1e-4)
    else:  # bf16 products on the card and on the CPU round differently
        assert np.abs(first["logp"] - ref)[valid].max() < 0.5


ZOO = ("external", "self", "simplified_self", "mobilevit_v2", "muse")


def _enlarge_zoo_ops(models, seed=0):
    """The zoo ops' parameters (``slf_attn.op.``) drawn N(0, 100/fan-in), the
    same on every model: at the zoo's N(0, 0.001²) init an op adds about
    1e-4 before the encoder's residual and LayerNorm, below the request's
    tolerance."""
    g = torch.Generator().manual_seed(seed)
    new = {n: 10 * torch.randn(p.shape, generator=g) / (p[0].numel() if p.ndim > 1
                                                       else p.numel()) ** 0.5
           for n, p in models[0].named_parameters() if "slf_attn.op." in n}
    with torch.no_grad():
        for model in models:
            params = dict(model.named_parameters())
            for name, value in new.items():
                params[name].copy_(value.to(params[name].device))


@pytest.mark.parametrize("kind", ZOO)
def test_zoo_kind_request_launches_the_recurrence_once_and_matches_cpu(cuda, kind):
    """MARN1_onlysp under each ``--encoder_attention`` zoo kind, its op's
    weights enlarged so that the op moves the log-probs by more than 2e-2: a
    request on the card runs the recurrence kernel once and agrees with the
    CPU at rtol 1e-3, atol 1e-4."""
    from ser_tpu_torch.models.registry import get_model_spec
    from ser_tpu_torch.serving import Predictor

    batch = synthetic_batch(L=20, B=6, seed=4, min_len=8)
    x, qmask, umask = get_model_spec("MARN1_onlysp").make_inputs(batch)
    gpu = Predictor(seed=0, encoder_attention=kind)
    at_init = gpu.predict(x, qmask, umask)[0].cpu()
    _enlarge_zoo_ops([gpu.model])
    cpu = Predictor(state_dict={k: v.cpu() for k, v in gpu.model.state_dict().items()},
                    device="cpu", encoder_attention=kind)
    before = LAUNCHES[tlsthm.NAME]
    logp = gpu.predict(x, qmask, umask)[0]
    torch.cuda.synchronize()
    assert LAUNCHES[tlsthm.NAME] == before + 1
    torch.testing.assert_close(logp.cpu(), cpu.predict(x, qmask, umask)[0],
                               rtol=1e-3, atol=1e-4)
    valid = torch.as_tensor(umask).reshape(-1) > 0
    assert (logp.cpu() - at_init)[valid].abs().max().item() > 2e-2


def test_infonce_muse_train_step_card_matches_cpu(cuda):
    """One onlysp step under ``muse`` with ``infonce=1e4`` on the card against
    the CPU, dropout off: 2T rank-1 launches, the loss at rtol 1e-5, every
    gradient within the train contract, the same dead set, the Adam update
    within 2.05 lr. The query is its own positive, so the term is the
    negatives' share of the softmax, about 1e-4: at 1e4 it is a sizable part
    of the loss and its gradients lie far above the tolerance
    (``tests/test_torch_infonce.py``)."""
    T = 16
    batch = synthetic_batch(L=T, B=4, seed=2, min_len=6)
    trainers = {d: ModelTrainer(device=d, seed=3, encoder_attention="muse", infonce=1e4)
                for d in ("cpu", "cuda")}
    _randomize_constants([t.model for t in trainers.values()])
    before = LAUNCHES[trank1.NAME]
    losses = {}
    for d, t in trainers.items():
        _no_dropout(t.model)
        losses[d] = t._train_step_impl(batch, 1e-3).item()
    assert LAUNCHES[trank1.NAME] == before + 2 * T
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-5)
    cpu = dict(trainers["cpu"].model.named_parameters())
    card = dict(trainers["cuda"].model.named_parameters())
    top = max(p.grad.abs().max().item() for p in cpu.values() if p.grad is not None)
    for name, p in cpu.items():
        q = card[name]
        assert (p.grad is None) == (q.grad is None), name
        if p.grad is not None:
            tol = 1e-3 * p.grad.abs().max().item() + 1e-6 * top
            assert (q.grad.cpu() - p.grad).abs().max().item() <= tol, name
        assert (q.detach().cpu() - p.detach()).abs().max().item() <= 2.05e-3, name


# --compute_dtype bf16: the bf16 form of the rank-1 kernel, and --dp

@pytest.mark.parametrize("B", [1, 31, 80])
@pytest.mark.parametrize("p", [0.0, 0.2])
def test_rank1_bf16_kernel_matches_plain_version(cuda, B, p):
    """bf16 in and out, counted under its own name: each output within one
    bf16 rounding of the plain bf16 form (2^-7 of it plus 1e-5, dwq and dwk
    1e-5 of their largest), and equal to the f32 kernel's on the widened
    inputs rounded once, which also shows the two forms draw one mask."""
    *ins, g = (t.bfloat16() for t in _rank1_inputs(B, cuda, seed=B))
    seed = torch.tensor([123456789], dtype=torch.int32, device=cuda)
    before = dict(LAUNCHES)
    got = _rank1_run(trank1.rank1_attention, ins, g, seed, 5, p)
    assert LAUNCHES[trank1.NAME_BF16] == before.get(trank1.NAME_BF16, 0) + 2
    assert LAUNCHES[trank1.NAME] == before.get(trank1.NAME, 0)
    want = _rank1_run(trank1.rank1_attention_ref, ins, g, seed, 5, p)
    wide = _rank1_run(trank1.rank1_attention, [t.float() for t in ins], g.float(), seed, 5, p)
    for name, a, b, c in zip(("z", "dx1", "dx2", "dwq", "dwk"), got, want, wide):
        assert a.dtype == torch.bfloat16 and torch.isfinite(a).all(), name
        a, b = a.float(), b.float()
        floor = 1e-5 * (b.abs().max().item() if name in ("dwq", "dwk") else 1.0)
        assert ((a - b).abs() <= floor + 2 ** -7 * b.abs()).all(), name
        assert torch.equal(a, c.bfloat16().float()), name


def test_rank1_bf16_kernel_bit_equal_runs_and_mixed_dtypes(cuda):
    *ins, g = (t.bfloat16() for t in _rank1_inputs(80, cuda, seed=3))
    seed = torch.tensor([42], dtype=torch.int32, device=cuda)
    runs = [_rank1_run(trank1.rank1_attention, ins, g, seed, 9, 0.2) for _ in range(3)]
    for run in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], run))
    with pytest.raises(ValueError, match="wk: torch.float32"):
        trank1.bind(ins[2], ins[3].float(), seed, 0.2)
    kernel = trank1.bind(ins[2], ins[3], seed, 0.2)
    with pytest.raises(ValueError, match="x1: torch.float32"):
        kernel(ins[0].float(), ins[1].float(), 0)
    with pytest.raises(ValueError, match="g: torch.float32"):
        kernel.backward(ins[0], ins[1], 0, g.float())


@pytest.mark.parametrize("name", ["MARN1_onlysp", "MARN1_nsps"])
def test_bf16_train_step_launches_the_bf16_kernel(cuda, name):
    """A bf16 step at [16, 4]: 2T bf16 launches (2T - 1 for nsps), no f32
    one, master state f32; its gradients lie as far from the f32 step's as
    on the CPU (1.5x plus 0.02, the constant-initialised parameters made
    random)."""
    T = 16
    batch = synthetic_batch(L=T, B=4, seed=2, min_len=6)
    dist = {}
    for d in ("cpu", "cuda"):
        grads = {}
        for dtype in ("f32", "bf16"):
            t = ModelTrainer(device=d, model=name, seed=3, compute_dtype=dtype)
            _randomize_constants([t.model])
            _no_dropout(t.model)
            before = dict(LAUNCHES)
            t._train_step_impl(batch, 1e-3)
            torch.cuda.synchronize()
            if d == "cuda" and dtype == "bf16":
                rise = {k: v - before.get(k, 0) for k, v in LAUNCHES.items()
                        if v != before.get(k, 0)}
                assert rise == {trank1.NAME_BF16: 2 * T - (name == "MARN1_nsps")}
                assert all(p.dtype is torch.float32 and (p.grad is None or
                                                         p.grad.dtype is torch.float32)
                           for p in t.model.parameters())
            grads[dtype] = torch.cat([(torch.zeros_like(p) if p.grad is None else p.grad)
                                      .double().cpu().reshape(-1)
                                      for p in t.model.parameters()])
        dist[d] = ((grads["bf16"] - grads["f32"]).norm() / grads["f32"].norm()).item()
    assert dist["cuda"] <= 1.5 * dist["cpu"] + 0.02, dist


def test_dp_one_nccl_rank_is_the_plain_step(cuda, monkeypatch):
    """``--dp`` as one NCCL rank: a step with dropout on is the plain step
    bit for bit (rank 0 keeps the seed's dropout stream)."""
    from ser_tpu_torch.parallel import initialize_distributed

    port = str(np.random.default_rng().integers(20000, 40000))
    for k, v in (("WORLD_SIZE", "1"), ("RANK", "0"), ("LOCAL_RANK", "0"),
                 ("MASTER_ADDR", "localhost"), ("MASTER_PORT", port)):
        monkeypatch.setenv(k, v)
    initialize_distributed("cuda")
    try:
        assert torch.distributed.get_backend() == "nccl"
        batch = synthetic_batch(L=16, B=4, seed=2, min_len=6)
        plain, dp = (ModelTrainer(seed=3, dp=flag) for flag in (False, True))
        assert dp.dp and not plain.dp
        losses = [t._train_step_impl(batch, 1e-3) for t in (plain, dp)]
        assert torch.equal(*losses)
        for p, q in zip(plain.model.parameters(), dp.model.parameters()):
            assert torch.equal(p, q)
    finally:
        torch.distributed.destroy_process_group()


# the train step as a CUDA graph (train/step_graph.py)

GRAPHED = ("MARN1_onlysp",) + VARIANTS + ("MARN1_mf", "MARN1_la")
GRAPH_SHAPES = ((110, 80), (109, 40), (110, 80))  # eager, eager, a replay


def _rank1_per_step(name, T):
    """Rank-1 launches of a train step: T forward and T backward; nsps and
    no_en leave the last z out of every output, so it has no backward; mf
    and la run none."""
    if name in ("MARN1_mf", "MARN1_la"):
        return 0
    return 2 * T - (name in ("MARN1_nsps", "MARN1_no_en"))


def _graphed_and_eager(name):
    """Two trainers of ``name`` from one init with every dropout rate at 0:
    one whose steps are graphs, and one with the same (capturable) Adam
    whose steps are eager."""
    graphed, eager = ModelTrainer(model=name, seed=3), ModelTrainer(model=name, seed=3)
    assert graphed.graphed and eager.optimizer.param_groups[0]["capturable"]
    eager.graphed = False
    _randomize_constants([graphed.model, eager.model])
    for t in (graphed, eager):
        _no_dropout(t.model)
    return graphed, eager


def _grads_within_contract(got, want):
    """Every gradient of ``got`` within 1e-3 of its tensor's largest in
    ``want`` plus 1e-6 of the step's largest, the same dead set (None)."""
    want = dict(want.model.named_parameters())
    top = max(p.grad.abs().max().item() for p in want.values() if p.grad is not None)
    dead = 0
    for name, q in got.model.named_parameters():
        p = want[name]
        assert (p.grad is None) == (q.grad is None), name
        if p.grad is None:
            dead += 1
            continue
        tol = 1e-3 * p.grad.abs().max().item() + 1e-6 * top
        assert (q.grad - p.grad).abs().max().item() <= tol, name
    return dead


@pytest.mark.parametrize("name", GRAPHED)
def test_train_graph_steps_match_eager_steps(cuda, name, monkeypatch):
    """Dropout off, [110, 80], [109, 40], [110, 80]: the first two steps
    capture their graphs, the third replays the first one. Each step's loss
    (read after all three, so each is its own) at rtol 1e-5 and its
    gradients within the train contract of the eager trainer's, dead
    parameters None in both; a replay counts the rank-1 launches its graph
    holds, as an eager step does."""
    from ser_tpu_torch.train import step_graph

    graphed, eager = _graphed_and_eager(name)
    replays = []
    replay = step_graph.StepGraph.replay
    monkeypatch.setattr(step_graph.StepGraph, "replay",
                        lambda self: replays.append(self) or replay(self))
    losses = {"graphed": [], "eager": []}
    for i, (L, B) in enumerate(GRAPH_SHAPES):
        batch = synthetic_batch(L=L, B=B, seed=10 + i, min_len=L // 3)
        for side, t in (("graphed", graphed), ("eager", eager)):
            before = LAUNCHES[trank1.NAME]
            losses[side].append(t._train_step_impl(batch, 1e-3))
            torch.cuda.synchronize()
            assert LAUNCHES[trank1.NAME] - before == _rank1_per_step(name, L), (side, i)
        assert len(replays) == (i == 2)
        dead = _grads_within_contract(graphed, eager)
        assert dead > 0
    assert len(graphed.graphs.graphs) == 2
    np.testing.assert_allclose([l.item() for l in losses["graphed"]],
                               [l.item() for l in losses["eager"]], rtol=1e-5)
    for p, q in zip(graphed.model.parameters(), eager.model.parameters()):
        assert (p - q).abs().max().item() <= 2.05e-3  # the Adam update within 2.05 lr


def test_train_graph_losses_are_each_steps_own(cuda):
    """Four steps of one key with dropout on (one eager, three replays):
    each returned loss still holds what it read when its step ended."""
    t = ModelTrainer(seed=3)
    batch = synthetic_batch(L=40, B=16, seed=1, min_len=10)
    losses, read = [], []
    for _ in range(4):
        losses.append(t._train_step_impl(batch, 1e-3))
        read.append(losses[-1].item())
    assert [l.item() for l in losses] == read
    assert len(set(read)) == 4


def test_train_graph_replays_draw_fresh_masks_at_their_rates(cuda, monkeypatch):
    """Each replay draws new masks from the trainer's generator: the
    ``dropout_rec`` output's kept share (where its input is not 0) and the
    rank-1 mask of each replay's seed (``keep_mask``, at steps 0 and 17)
    within 6 binomial sigmas of 1 - p, and no two replays alike."""
    from ser_tpu_torch.models import marn_onlysp

    t = ModelTrainer(seed=3)
    seen = {}
    t.model.dropout_rec.register_forward_hook(
        lambda m, args, out: seen.update(drop=(args[0], out)))
    bind = marn_onlysp.rank1_bind
    monkeypatch.setattr(marn_onlysp, "rank1_bind", lambda wq, wk, seed, p: (
        seen.update(seed=seed, p=p) or bind(wq, wk, seed, p)))
    L, B = 32, 16
    batch = synthetic_batch(L=L, B=B, seed=1, min_len=L)
    t._train_step_impl(batch, 1e-3)  # eager, then the capture: seen holds its tensors
    (x, out), seed = seen["drop"], seen["seed"]
    assert seen["p"] == t.model.attn_dropout
    masks, seeds = [], []
    for _ in range(3):
        t._train_step_impl(batch, 1e-3)
        masks.append((out != 0)[x != 0])
        seeds.append(seed.clone())
    p = t.model.dropout_rec.p
    for mask in masks:
        sigma = (p * (1 - p) / mask.numel()) ** 0.5
        assert abs(mask.float().mean().item() - (1 - p)) <= 6 * sigma
    assert not torch.equal(masks[0], masks[1]) and not torch.equal(masks[1], masks[2])
    assert len({s.item() for s in seeds}) == 3
    pa = t.model.attn_dropout
    for s in seeds:
        for step in (0, 17):
            keep = trank1.keep_mask(s, step, B, pa)
            sigma = (pa * (1 - pa) / keep.numel()) ** 0.5
            assert abs(keep.float().mean().item() - (1 - pa)) <= 6 * sigma


def test_train_graph_after_reloads_matches_eager(cuda):
    """The benchmark's check on a warmed trainer: the model's weights back
    (``load_state_dict``, in place, which keeps the graphs) and the
    optimizer's first state (which drops them); then a first sight and a
    replay match the eager trainer's first two steps."""
    import copy

    graphed, eager = _graphed_and_eager("MARN1_onlysp")
    weights = {k: v.clone() for k, v in graphed.model.state_dict().items()}
    start = copy.deepcopy(graphed.optimizer.state_dict())
    batch = synthetic_batch(L=48, B=16, seed=4, min_len=12)
    for _ in range(3):
        graphed._train_step_impl(batch, 1e-3)
    graphed.model.load_state_dict(weights)
    assert len(graphed.graphs.graphs) == 1
    graphed.optimizer.load_state_dict(start)
    assert not graphed.graphs.graphs
    for _ in range(2):
        got, want = (t._train_step_impl(batch, 1e-3).item() for t in (graphed, eager))
        np.testing.assert_allclose(got, want, rtol=1e-5)
        _grads_within_contract(graphed, eager)
    for p, q in zip(graphed.model.parameters(), eager.model.parameters()):
        assert (p - q).abs().max().item() <= 2.05e-3  # the Adam update within 2.05 lr


def test_train_graph_resume_restores_the_dropout_stream(cuda, tmp_path):
    """Dropout on: two replays after ``save_train_state``, then
    ``load_train_state`` (which drops the graphs) and the same two steps
    again, a first sight and a replay: the same losses, so the generator's
    state, which every replay advances, was saved and restored."""
    t = ModelTrainer(seed=3)
    batch = synthetic_batch(L=40, B=16, seed=2, min_len=10)
    t._train_step_impl(batch, 1e-3)
    t.save_train_state(str(tmp_path / "s.npz"), 1)
    first = [t._train_step_impl(batch, 1e-3).item() for _ in range(2)]
    t.load_train_state(str(tmp_path / "s.npz"))
    assert not t.graphs.graphs
    again = [t._train_step_impl(batch, 1e-3).item() for _ in range(2)]
    np.testing.assert_allclose(again, first, rtol=1e-5)
