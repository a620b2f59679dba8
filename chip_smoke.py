#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ser_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
 1. the card's name and power limit, torch and CUDA versions; TF32 off;
 2. build every kernel from ``ser_tpu_torch/csrc`` with nvcc, one process
    per source, all started together; registers and spills of every kernel,
    for the recurrence its cluster size, the clusters the card holds at
    once and the shared memory a CTA at each tile height, and for the MFCC
    kernel its shared memory a block and the blocks an SM holds;
 3. the recurrence kernel against its plain PyTorch version on the card at
    T = 110 for B on both sides of every tile height, at T = 1 and with a
    fully padded row, every launch synchronised, and twice on one input for
    bit-equal outputs;
 3b. the MFCC kernel against its plain version at the IEMOCAP eval wav
    shape, at ``bench.py``'s [1606, 4000], at 1 s utterances (several tiles
    a row, a ragged last tile), at rows that start off 16-byte alignment, at
    one frame, at hop 200, on a 440 Hz tone and at all-zero rows (equal to
    the plain version's bit for bit), every shape twice for bit-equal
    outputs;
 4. the feature path: a ``Predictor`` with seeded full-width MARN1_onlysp
    weights answers three requests (the IEMOCAP eval shape, one dialogue,
    the reference train shape [110, 80]); each must launch the recurrence
    kernel once and match the same model on the CPU, which runs the plain
    path;
 4b. the raw-audio path: ``Predictor(audio_frontend="mfcc")`` answers a
    collated request with waveforms at the IEMOCAP eval shape [82, 31],
    4000 samples bucketed to 4096; it must launch the MFCC kernel and the
    recurrence kernel once each and match the CPU;
 4c. the entry point: ``python -m ser_tpu_torch.predict --synthetic
    --audio_frontend mfcc`` with a seeded checkpoint on the card, against a
    ``--device cpu`` run on the same pickles;
 5. CUDA-event timings: the recurrence kernel, its plain version, its
    chain floor (T rounds of its cluster exchanges with no work between
    them) and a whole feature request at the IEMOCAP eval shape; the
    recurrence over B; the MFCC kernel at the eval wav shape a wrapper call
    and as device time (launches replayed from a CUDA graph), on one input
    and on three inputs taken in turn (125 MB, more than the L2 holds), its
    bytes floor (its grid, loads and stores with no arithmetic) both ways,
    its plain version, the function's bound and the operation time of the
    kernel's own algorithm; front-end
    utterances/s at ``bench.py``'s shape; a whole wav request;
 6. ``torch.profiler`` breakdowns of a feature request and of a wav request
    by kernel and copy.
The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Without CUDA, or without the package
beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import csv
import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
F32_PEAK = 67e12   # H100 SXM f32 FLOP/s outside the tensor cores (data sheet)
HBM_RATE = 3.35e12  # H100 SXM HBM3 bytes/s (data sheet)
# kernel vs plain: the spectrum by an FFT against dense DFT products (other
# roundings of the window and the sums), then 64-term sums of logs up to 13.8
MFCC_RTOL, MFCC_ATOL = 1e-5, 2e-4
WAV_T, WAV_BUCKET_T = 4000, 4096  # bench.py's utterance, collate's bucket
PREDICT_SEED = 111  # the predict CLI's default --seed, which --synthetic uses


def check(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


def cuda_graph_ms(torch, fn, calls=21, replays=7):
    """Milliseconds of device time a call of ``fn``: ``calls`` calls captured
    into one CUDA graph, the graph replayed between two CUDA events, the
    median over ``replays``. No host work lies between the launches, so the
    reading does not follow the host as a timed wrapper call does."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return cuda_ms(torch, graph.replay, warmup=2, iters=replays) / calls


def cuda_ms(torch, fn, warmup=3, iters=20):
    """Median milliseconds of ``fn`` between two CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def ptxas_summary(log):
    """One line a kernel from ``nvcc -Xptxas -v``: name, registers, spills."""
    lines = []
    for name, body in re.findall(
            r"Compiling entry function '(\w+)'(.*?)(?=ptxas info\s*: Compiling|\Z)",
            log, re.S):
        short = re.search(r"\d+([a-z_]+kernel(?:IL[ib]\d+E)?)", name)
        regs = re.search(r"Used (\d+) registers", body)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", body)
        lines.append(f"{short.group(1) if short else name}: "
                     f"{regs.group(1) if regs else '?'} registers, spill stores "
                     f"{spill.group(1) if spill else '?'} B, loads "
                     f"{spill.group(2) if spill else '?'} B")
    return lines


def recurrence_inputs(np, torch, T, B, seed, dev, padded_row=None):
    """Seeded kernel inputs at full width (H = 128), scaled like the
    recurrence's real inputs, with a padded tail (all-zero qmask) on the
    later half of the rows; row ``padded_row`` is padded at every step."""
    H = 128
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(
        (0.1 * rng.standard_normal(s)).astype(np.float32)).to(dev)
    lengths = rng.integers(max(1, T // 2), T + 1, size=B)
    sp = rng.integers(0, 2, size=(T, 2, B))
    qm = np.zeros((T, 2, B, 2), np.float32)
    qm[np.arange(T)[:, None, None], np.arange(2)[None, :, None],
       np.arange(B)[None, None, :], sp] = 1
    qm *= (np.arange(T)[:, None] < lengths[None, :])[:, None, :, None]
    if padded_row is not None:
        qm[:, :, padded_row] = 0
    seqs = (f(T, 2, B, 4 * H), f(T, 2, B, 4 * H), f(T, 2, B, 3 * H),
            torch.from_numpy(qm).to(dev))
    consts = (f(2, 3 * H, 4 * H), f(2, 4 * H), f(2, 3 * H, 4 * H),
              f(2, 4 * H), f(2, H, 3 * H), f(2, 3 * H), f(2, H), f(2, H))
    return seqs, consts


def recurrence_bound(seqs, consts, out):
    """Least time for the recurrence: each input read once, the output
    written once; per (step, direction, row) the GRU h-side product
    2*H*3H, both LSTHM products 2*2*3H*4H, the attention 5*H*H (multiply,
    subtract, exp, multiply-add, add) and the s dot 2*H."""
    T, _, B = seqs[0].shape[:3]
    H = 128
    flops = T * 2 * B * (2 * H * 3 * H + 4 * 3 * H * 4 * H + 5 * H * H + 2 * H)
    nbytes = sum(t.numel() * t.element_size() for t in (*seqs, *consts, out))
    t_ops, t_bytes = flops / F32_PEAK * 1e3, nbytes / HBM_RATE * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def mfcc_bound(x, consts, out, cfg):
    """Least time for the MFCC function, whatever the algorithm: the
    waveform, the mel filterbank and the DCT matrix read once, the
    coefficients written once (an FFT reads no DFT matrix); pre-emphasis 2
    flops a sample, and per frame the window win, a real FFT of n_fft
    2.5*n_fft*log2(n_fft) (FFTW's count), the power 3*nbins, 2 per nonzero
    of the filterbank, log(. + eps) 2*n_mels and a fast DCT
    2.5*n_mels*log2(n_mels). Returns ``(ms, bound_by, own_ms)`` with
    ``own_ms`` the operations time of the kernel's own algorithm: a
    256-point complex FFT in passes of radix 8, 8 and 4 (56 flops a radix-8
    butterfly, 16 a radix-4, 6 a twiddle product: 32*56*2 + 64*16 +
    2*32*7*6), the split and power of 128 bin pairs at 20 flops and bin
    128 at 5, the filterbank's nonzeros, and the DCT as a dense product."""
    N, T = x.shape
    frames = N * cfg.n_frames(T)
    nbins = cfg.n_fft // 2 + 1
    mel, dct = consts[2], consts[3]
    per_frame = (cfg.win_length + 2.5 * cfg.n_fft * math.log2(cfg.n_fft)
                 + 3 * nbins + 2 * int((mel != 0).sum()) + 2 * cfg.n_mels
                 + 2.5 * cfg.n_mels * math.log2(cfg.n_mels))
    own = (cfg.win_length + 2 * 32 * 56 + 64 * 16 + 2 * 32 * 7 * 6
           + 20 * (cfg.n_fft // 4) + 5 + 2 * int((mel != 0).sum())
           + 2 * cfg.n_mels + 2 * cfg.n_mels * cfg.n_mfcc)
    flops = 2 * N * T + frames * per_frame
    nbytes = sum(t.numel() * t.element_size() for t in (x, mel, dct, out))
    t_ops, t_bytes = flops / F32_PEAK * 1e3, nbytes / HBM_RATE * 1e3
    own_ms = (2 * N * T + frames * own) / F32_PEAK * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes",
            own_ms)


def wav_request(np, batch, seed):
    """``batch`` as ``data.collate`` pads it with raw audio: WAV_T seeded
    samples for every real utterance, zeros in every padded slot, the
    sample axis bucketed to WAV_BUCKET_T, ``wav_len`` per dialogue."""
    L, B = batch["qmask"].shape[:2]
    rng = np.random.default_rng(seed)
    wav = np.zeros((L, B, WAV_BUCKET_T), np.float32)
    wav[:, :, :WAV_T] = (0.5 * rng.standard_normal((L, B, WAV_T))).astype(
        np.float32) * batch["umask"].T[:, :, None]
    return dict(batch, wav=wav, wav_len=np.full(B, WAV_T, np.int32))


def read_res_csv(path):
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    return ([int(r["preds"]) for r in rows], [int(r["labels"]) for r in rows],
            [float(r["masks"]) for r in rows])


def device_profile(torch, fn, n):
    """Device events of ``n`` calls of ``fn`` under ``torch.profiler``:
    ``(wall ms, busy ms, events)`` with events the kernels and copies."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()  # kernels and copies, not host ops
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.key.startswith("Activity Buffer")]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    return wall_ms, busy_ms, events


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if not (ROOT / "ser_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no ser_tpu_torch package beside {__file__}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from ser_tpu_torch.compat.from_jax import to_jax_params
    from ser_tpu_torch.data.frontend import MFCCFrontend
    from ser_tpu_torch.data.synthetic import (generate_iemocap_pickles,
                                              iemocap_eval_batch,
                                              synthetic_batch)
    from ser_tpu_torch.device import disable_tf32
    from ser_tpu_torch.models.registry import get_model_spec
    from ser_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from ser_tpu_torch.ops.kernels import mfcc as mfcc_kernel
    from ser_tpu_torch.ops.kernels.build import build
    from ser_tpu_torch.ops.kernels.lsthm import (
        CLUSTER, NAME, TILE_ROWS, choose_tiling, launch_exchange_rounds,
        lsthm_onlysp_recurrence_bidir, lsthm_onlysp_recurrence_bidir_ref,
        occupancy)
    from ser_tpu_torch.ops.mfcc import MFCCConfig, mfcc, mfcc_ref
    from ser_tpu_torch.serving import Predictor
    from ser_tpu_torch.train.metrics import weighted_accuracy

    MFCC = mfcc_kernel.NAME

    # 1. the card
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    disable_tf32()
    dev = torch.device("cuda:0")

    # 2. build
    t0 = time.perf_counter()
    logs = build([NAME, MFCC])
    print(f"[build] {NAME}.cu, {MFCC}.cu in {time.perf_counter() - t0:.1f} s")
    for name in (NAME, MFCC):
        for line in ptxas_summary(logs.get(name, "")):
            print(f"[build]   {name}: {line}")
    cfg = MFCCFrontend().cfg  # the path's 64 mels, 50 coefficients
    mfcc_smem, mfcc_blocks = mfcc_kernel.occupancy(cfg)
    print(f"[build]   {MFCC}: tiles of {mfcc_kernel.TILE_FRAMES} frames, "
          f"{mfcc_smem} B of dynamic shared memory a block, {mfcc_blocks} blocks "
          f"an SM on {torch.cuda.get_device_properties(0).multi_processor_count} SMs")
    check(mfcc_blocks >= 1, f"an SM holds no block of the {MFCC} kernel")
    max_clusters = occupancy()[1]
    print(f"[build]   {NAME}: clusters of {CLUSTER} CTAs, {max_clusters} resident "
          "at once; dynamic shared memory a CTA by rows a cluster: " + ", ".join(
              f"{rows}: {occupancy(rows)[0]} B" for rows in TILE_ROWS))
    check(max_clusters >= 1, f"the card holds no cluster of {CLUSTER} CTAs")

    # 3. recurrence kernel against its plain version, atol 1e-4 (110 serial
    #    steps sum in another order than the plain version's matmuls): B on
    #    both sides of every tile height, one step, a fully padded row; every
    #    launch synchronised, so a fault in a cluster write shows here
    max_err = 0.0
    for T_k, B, padded_row in ((110, 1, None), (110, 8, None), (110, 9, None),
                               (110, 12, None), (110, 13, None), (110, 31, None),
                               (110, 33, None), (110, 37, None), (110, 80, None),
                               (1, 31, None), (110, 31, 5)):
        seqs, consts = recurrence_inputs(np, torch, T_k, B, seed=B, dev=dev,
                                         padded_row=padded_row)
        rows, tiles = choose_tiling(B, max_clusters)
        got = lsthm_onlysp_recurrence_bidir(seqs, consts)
        torch.cuda.synchronize()
        again = lsthm_onlysp_recurrence_bidir(seqs, consts)
        torch.cuda.synchronize()
        want = lsthm_onlysp_recurrence_bidir_ref(seqs, consts)
        err = (got - want).abs().max().item()
        max_err = max(max_err, err)
        what = f"B={B:3d} T={T_k}" + (
            "" if padded_row is None else f" row {padded_row} padded")
        print(f"[kernel] {what}: {rows} rows a cluster, {2 * tiles} clusters, "
              f"max|kernel-plain| = {err:.3e}, two runs bit-equal: "
              f"{torch.equal(got, again)}")
        check(torch.isfinite(got).all().item(), f"non-finite kernel output, {what}")
        check(err <= 1e-4, f"kernel disagrees with plain version, {what}")
        check(torch.equal(got, again), f"two runs of one input differ, {what}")

    # 3b. MFCC kernel against its plain version, |err| <= MFCC_ATOL +
    #     MFCC_RTOL*|plain|; every shape twice for bit-equal outputs; all-zero
    #     rows must equal the plain version's bit for bit (they reach the
    #     logits as padding)
    eval_batch, n_utts = iemocap_eval_batch(seed=0)
    wav_batch = wav_request(np, eval_batch, seed=5)
    L, B = eval_batch["qmask"].shape[:2]
    wav_rows = torch.from_numpy(wav_batch["wav"].reshape(L * B, -1)).to(dev)
    rng = np.random.default_rng(3)
    noise = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(dev)
    bench_wav = noise(n_utts, WAV_T)
    tone = torch.sin(2 * math.pi * 440 / 16000 * torch.arange(
        WAV_BUCKET_T, device=dev, dtype=torch.float64)).float()
    hop200 = MFCCConfig(hop=200, n_mels=cfg.n_mels, n_mfcc=cfg.n_mfcc)
    mfcc_err = 0.0
    for name, x, c in (
            ("iemocap_eval_wav", wav_rows, cfg),
            ("bench_1606x4000", bench_wav, cfg),
            ("one_second", noise(4, 16000), cfg),
            ("unaligned_rows", noise(5, 4001), cfg),
            ("one_frame", noise(1, 400), cfg),
            ("hop_200", noise(37, WAV_BUCKET_T), hop200),
            ("tone_440hz", torch.stack([tone, 1e-3 * tone]), cfg),
            ("all_zero_rows", torch.zeros(64, WAV_BUCKET_T, device=dev), cfg)):
        got = mfcc(x, c)
        torch.cuda.synchronize()
        again = mfcc(x, c)
        torch.cuda.synchronize()
        want = mfcc_ref(x, c)
        err = (got - want).abs()
        worst = (err / (MFCC_ATOL + MFCC_RTOL * want.abs())).max().item()
        mfcc_err = max(mfcc_err, err.max().item())
        print(f"[kernel] {MFCC} {name} {tuple(x.shape)} -> {tuple(got.shape)}: "
              f"max|kernel-plain| = {err.max().item():.3e}, "
              f"{worst:.3f} of the tolerance, two runs bit-equal: "
              f"{torch.equal(got, again)}")
        check(torch.isfinite(got).all().item(), f"non-finite MFCC output, {name}")
        check(got.shape == (x.shape[0], c.n_frames(x.shape[1]), c.n_mfcc),
              f"MFCC output shape, {name}")
        check(worst <= 1.0, f"MFCC kernel disagrees with plain version, {name}")
        check(torch.equal(got, again), f"two MFCC runs of one input differ, {name}")
        if name == "all_zero_rows":
            check(torch.equal(got, want),
                  "all-zero rows differ from the plain version's padded features")

    # 4. the feature path: three requests through the Predictor
    spec = get_model_spec("MARN1_onlysp")
    n0 = int(eval_batch["umask"][0].sum())  # dialogue 0 alone, unpadded
    one = {k: (v[:1, :n0] if k in ("umask", "label") else v[:n0, :1])
           for k, v in eval_batch.items() if k != "vid"}
    train_batch = synthetic_batch(L=110, B=80, seed=1, min_len=20)
    requests = [("iemocap_eval", eval_batch), ("one_dialogue", one),
                ("train_shape", train_batch)]

    gpu = Predictor(seed=0, device="cuda")
    weights = {k: v.cpu() for k, v in gpu.model.state_dict().items()}
    cpu = Predictor(state_dict=weights, device="cpu")
    reset_launches()
    per_request = []
    for name, batch in requests:
        x, qmask, umask = spec.make_inputs(batch)
        before = LAUNCHES[NAME]
        logp, labels = gpu.predict(x, qmask, umask)
        torch.cuda.synchronize()
        per_request.append((name, x, qmask, umask, logp.cpu(),
                            LAUNCHES[NAME] - before))
    main_launches = LAUNCHES[NAME]
    check(main_launches > 0, f"{NAME} was never launched on the main path")
    for name, x, qmask, umask, logp, launches in per_request:
        L_, B_ = x.shape[:2]
        ref = cpu.predict(x, qmask, umask)[0]
        err = (logp - ref).abs().max().item()
        ok = torch.allclose(logp, ref, rtol=1e-3, atol=1e-4)
        print(f"[predict] {name}: L={L_} B={B_} logp {tuple(logp.shape)} "
              f"launches={launches} max|gpu-cpu|={err:.3e}")
        check(torch.isfinite(logp).all().item(), f"non-finite logp for {name}")
        check(tuple(logp.shape) == (B_ * L_, 6), f"logp shape for {name}")
        check(launches == 1, f"{name} launched {NAME} {launches} times")
        check(ok, f"{name}: card and CPU disagree beyond rtol 1e-3, atol 1e-4")
    check(gpu.n_requests == 3, "the predictor did not count three requests")

    # 4b. the raw-audio path: one collated wav request, front end on the card
    gpu_wav = Predictor(state_dict=weights, device="cuda", audio_frontend="mfcc")
    cpu_wav = Predictor(state_dict=weights, device="cpu", audio_frontend="mfcc")
    reset_launches()
    logp, _ = gpu_wav.predict_batch(wav_batch)
    torch.cuda.synchronize()
    wav_launches = dict(LAUNCHES)
    logp = logp.cpu()
    ref = cpu_wav.predict_batch(wav_batch)[0]
    err = (logp - ref).abs().max().item()
    print(f"[predict] iemocap_eval_wav: L={L} B={B} T={WAV_BUCKET_T} "
          f"logp {tuple(logp.shape)} launches={wav_launches} "
          f"max|gpu-cpu|={err:.3e}")
    check(torch.isfinite(logp).all().item(), "non-finite logp for the wav request")
    check(wav_launches.get(MFCC, 0) == 1 and wav_launches.get(NAME, 0) == 1,
          f"the wav request launched {wav_launches}, want {MFCC} and {NAME} once")
    check(torch.allclose(logp, ref, rtol=1e-3, atol=1e-4),
          "wav request: card and CPU disagree beyond rtol 1e-3, atol 1e-4")

    # 4c. the entry point on the card and on the CPU, the same pickles
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        tmp = Path(tmp)
        ckpt = tmp / "marn1_onlysp_seed0.npz"
        np.savez(ckpt, **to_jax_params(weights))
        feature_path = generate_iemocap_pickles(
            str(tmp / "pickles"), seed=PREDICT_SEED, with_wav=True)
        cli = [sys.executable, "-m", "ser_tpu_torch.predict",
               "--audio_frontend", "mfcc", "--initial_model", str(ckpt)]
        runs = {
            "cuda": cli + ["--synthetic", "--res_csv", str(tmp / "cuda.csv")],
            "cpu": cli + ["--feature_path", feature_path, "--device", "cpu",
                          "--res_csv", str(tmp / "cpu.csv")],
        }
        t0 = time.perf_counter()
        procs = {k: subprocess.Popen(c, cwd=ROOT, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True)
                 for k, c in runs.items()}
        outs = {k: p.communicate(timeout=600) for k, p in procs.items()}
        print(f"[cli] both runs in {time.perf_counter() - t0:.1f} s")
        reports = {}
        for k, (out, errs) in outs.items():
            check(procs[k].returncode == 0,
                  f"predict CLI ({k}) exited {procs[k].returncode}:\n{errs[-3000:]}")
            check("is not in the model" not in out and "Wrong parameter" not in out,
                  f"predict CLI ({k}) skipped checkpoint names:\n{out[:2000]}")
            reports[k] = json.loads(out[out.index("{"):])
        preds, labels, masks = read_res_csv(tmp / "cuda.csv")
        cpu_preds, cpu_labels, cpu_masks = read_res_csv(tmp / "cpu.csv")
    rep = reports["cuda"]
    print(f"[cli] cuda: {json.dumps(rep)}")
    print(f"[cli] cpu:  {json.dumps(reports['cpu'])}")
    valid = [i for i, m in enumerate(masks) if m > 0]
    flips = sum(preds[i] != cpu_preds[i] for i in valid)
    print(f"[cli] predictions differ on {flips} of {len(valid)} valid utterances")
    check(labels == cpu_labels and masks == cpu_masks,
          "the card and CPU runs read different pickles")
    check(rep["n_examples"] == 31 and len(valid) > 0, "predict CLI test split")
    check(all(math.isfinite(rep[k]) for k in ("weighted_accuracy", "weighted_f1")),
          "non-finite CLI metrics")
    check(rep["weighted_accuracy"] == weighted_accuracy(labels, preds, masks),
          "CLI accuracy does not match its res.csv")
    check(flips <= 0.001 * len(valid), "card and CPU predictions differ on "
          "more than 0.1% of the valid utterances")

    # 5. timings
    x, qmask, umask = spec.make_inputs(eval_batch)
    xt, qt, ut = (torch.as_tensor(a, device=dev) for a in (x, qmask, umask))
    with torch.inference_mode():
        seqs, consts = gpu.model.recurrence_inputs(xt, qt, ut)[:2]
        out = lsthm_onlysp_recurrence_bidir(seqs, consts)
        err = (out - lsthm_onlysp_recurrence_bidir_ref(seqs, consts)).abs().max().item()
        max_err = max(max_err, err)
        check(err <= 1e-4, "kernel disagrees with plain version at the eval shape")
        kernel_ms = cuda_ms(torch, lambda: lsthm_onlysp_recurrence_bidir(seqs, consts))
        plain_ms = cuda_ms(torch, lambda: lsthm_onlysp_recurrence_bidir_ref(seqs, consts),
                           warmup=1, iters=5)
    predict_ms = cuda_ms(torch, lambda: gpu.predict(x, qmask, umask))
    for B_sweep in (1, 8, 31, 80):  # how the per-step time depends on B
        s_in, c_in = recurrence_inputs(np, torch, 82, B_sweep, seed=7, dev=dev)
        rows, tiles = choose_tiling(B_sweep, max_clusters)
        ms = cuda_ms(torch, lambda: lsthm_onlysp_recurrence_bidir(s_in, c_in))
        print(f"[time] {card} | kernel T=82 B={B_sweep}: {ms:.4f} ms "
              f"({ms / 82 * 1e3:.2f} us/step), {rows} rows a cluster, "
              f"{2 * tiles} clusters of {max_clusters} resident")
    bound_ms, bound_by = recurrence_bound(seqs, consts, out)
    T, _, B_rec = seqs[0].shape[:3]
    # the chain floor: what T steps' cluster exchanges cost with no work
    # between them, on the grid this shape runs on (20 calls' worth a launch)
    rows, tiles = choose_tiling(B_rec, max_clusters)
    floor_ms = cuda_ms(torch, lambda: launch_exchange_rounds(
        20 * T, rows, tiles), warmup=1, iters=5) / 20
    print(f"[time] {card} | recurrence T={T} B={B_rec}: kernel {kernel_ms:.4f} ms "
          f"({kernel_ms / T * 1e3:.2f} us/step), plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}), chain floor {floor_ms:.4f} ms "
          f"(T x {floor_ms / T * 1e3:.2f} us of cluster exchanges)")
    print(f"[time] {card} | predict {n_utts} utterances: {predict_ms:.4f} ms, "
          f"{n_utts / predict_ms * 1e3:.1f} utterances/s")

    # the MFCC kernel a wrapper call (host work before the launch included)
    # and as device time from a CUDA graph, on one input (which the 50 MB L2
    # holds in part from launch to launch) and on three inputs taken in turn
    # (125 MB: every launch finds its waveform in device memory, as a request
    # does); the bytes floor both ways
    mfcc_out = mfcc(wav_rows, cfg)
    turn = [wav_rows, wav_rows.flip(0).contiguous(), wav_rows.roll(1, 0).contiguous()]

    def in_turn(fn):
        calls = iter(range(10 ** 6))
        return lambda: fn(turn[next(calls) % 3], cfg)

    mfcc_ms = cuda_ms(torch, lambda: mfcc(wav_rows, cfg))
    mfcc_turn_ms = cuda_ms(torch, in_turn(mfcc), iters=21)
    mfcc_dev_ms = cuda_graph_ms(torch, lambda: mfcc(wav_rows, cfg))
    mfcc_dev_turn_ms = cuda_graph_ms(torch, in_turn(mfcc))
    floor = mfcc_kernel.launch_bytes_floor
    mfcc_floor_ms = cuda_graph_ms(torch, lambda: floor(wav_rows, cfg))
    mfcc_floor_turn_ms = cuda_graph_ms(torch, in_turn(floor))
    mfcc_plain_ms = cuda_ms(torch, lambda: mfcc_ref(wav_rows, cfg))
    mfcc_bound_ms, mfcc_bound_by, own_ms = mfcc_bound(
        wav_rows, cfg.tensors(dev), mfcc_out, cfg)
    print(f"[time] {card} | {MFCC} {tuple(wav_rows.shape)}: kernel {mfcc_ms:.4f} ms "
          f"a wrapper call, {mfcc_dev_ms:.4f} of device time; three inputs in turn "
          f"{mfcc_turn_ms:.4f} and {mfcc_dev_turn_ms:.4f}; bytes floor "
          f"{mfcc_floor_ms:.4f}, three inputs in turn {mfcc_floor_turn_ms:.4f}; "
          f"plain {mfcc_plain_ms:.4f} ms; bound {mfcc_bound_ms:.4f} ms "
          f"({mfcc_bound_by}), {100 * mfcc_bound_ms / mfcc_ms:.1f}% of the bound "
          f"a wrapper call, {100 * mfcc_bound_ms / mfcc_dev_turn_ms:.1f}% in device "
          f"time in turn; the kernel's own algorithm's operations {own_ms:.4f} ms")
    bench_kernel_ms = cuda_graph_ms(torch, lambda: mfcc(bench_wav, cfg))
    frontend_ms = cuda_ms(torch, lambda: gpu_wav.frontend(bench_wav))
    print(f"[time] {card} | front end {tuple(bench_wav.shape)}: kernel "
          f"{bench_kernel_ms:.4f} ms of device time, with pooling {frontend_ms:.4f} ms, "
          f"{n_utts / frontend_ms * 1e3:.1f} utterances/s")
    wav_predict_ms = cuda_ms(torch, lambda: gpu_wav.predict_batch(wav_batch),
                             warmup=2, iters=10)
    print(f"[time] {card} | wav request {n_utts} utterances [{L}, {B}, "
          f"{WAV_BUCKET_T}]: {wav_predict_ms:.4f} ms, "
          f"{n_utts / wav_predict_ms * 1e3:.1f} utterances/s")

    # 6. where the time of a request goes: device time by kernel and copy,
    #    and the device's busy share of the wall time
    for label, fn, n in (("feature request", lambda: gpu.predict(x, qmask, umask), 5),
                         ("wav request", lambda: gpu_wav.predict_batch(wav_batch), 3)):
        wall_ms, busy_ms, events = device_profile(torch, fn, n)
        print(f"[profile] {card} | {label}, {n} requests: wall {wall_ms:.3f} ms, "
              f"device busy {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%)")
        split = {"HtoD copy": 0.0, MFCC: 0.0, NAME: 0.0, "rest": 0.0}
        for e in events:
            key = ("HtoD copy" if "HtoD" in e.key else MFCC if "mfcc_kernel" in e.key
                   else NAME if "lsthm_onlysp_cluster" in e.key else "rest")
            split[key] += e.self_device_time_total / n / 1e3
        print("[profile]   ms/request: " + ", ".join(
            f"{k} {v:.4f}" for k, v in split.items()))
        for e in sorted(events, key=lambda e: e.self_device_time_total,
                        reverse=True)[:10]:
            if e.self_device_time_total > 0:
                print(f"[profile]   {e.self_device_time_total / n / 1e3:9.4f} "
                      f"ms/request x{e.count // n:<4d} {e.key[:90]}")

    print(json.dumps({"kernels": [{
        "name": NAME, "route": "cuda",
        "source": "ser_tpu_torch/csrc/lsthm_onlysp.cu",
        "replaces": "ser_tpu/ops/pallas/lsthm.py:296",
        "launches": main_launches, "max_abs_err": max_err,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None}, {
        "name": MFCC, "route": "cuda",
        "source": "ser_tpu_torch/csrc/mfcc.cu",
        "replaces": "ser_tpu/ops/pallas/mfcc.py:152",
        "launches": wav_launches[MFCC], "max_abs_err": mfcc_err,
        "ms": mfcc_ms, "plain_ms": mfcc_plain_ms, "bound_ms": mfcc_bound_ms,
        "bound_by": mfcc_bound_by, "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
