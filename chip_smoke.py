#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ser_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
 1. the card's name and power limit, torch and CUDA versions; TF32 off;
 2. build every kernel from ``ser_tpu_torch/csrc`` with nvcc;
 3. each kernel against its plain PyTorch version on the card, at the
    shapes the main path gives it;
 4. the main path: a ``Predictor`` with seeded full-width MARN1_onlysp
    weights answers three requests (the IEMOCAP eval shape, one dialogue,
    the reference train shape [110, 80]); each must launch the recurrence
    kernel once and match the same model on the CPU, which runs the plain
    path;
 5. CUDA-event timings at the IEMOCAP eval shape: the kernel, its plain
    version, the whole ``predict``;
 6. a ``torch.profiler`` breakdown of a request's device time by kernel.
The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Without CUDA, or without the package
beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
F32_PEAK = 67e12   # H100 SXM f32 FLOP/s outside the tensor cores (data sheet)
HBM_RATE = 3.35e12  # H100 SXM HBM3 bytes/s (data sheet)


def check(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


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


def recurrence_inputs(np, torch, T, B, seed, dev):
    """Seeded kernel inputs at full width (H = 128), scaled like the
    recurrence's real inputs, with a padded tail (all-zero qmask) on the
    later half of the rows."""
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

    from ser_tpu_torch.data.synthetic import iemocap_eval_batch, synthetic_batch
    from ser_tpu_torch.device import disable_tf32
    from ser_tpu_torch.models.registry import get_model_spec
    from ser_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from ser_tpu_torch.ops.kernels.build import build
    from ser_tpu_torch.ops.kernels.lsthm import (
        NAME, lsthm_onlysp_recurrence_bidir, lsthm_onlysp_recurrence_bidir_ref)
    from ser_tpu_torch.serving import Predictor

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
    logs = build([NAME])
    print(f"[build] {NAME}.cu in {time.perf_counter() - t0:.1f} s")
    for line in logs.get(NAME, "").splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"[build]   {line.strip()}")

    # 3. kernel against its plain version, T = 110, atol 1e-4 (110 serial
    #    steps sum in another order than the plain version's matmuls)
    max_err = 0.0
    for B in (1, 31, 80):
        seqs, consts = recurrence_inputs(np, torch, 110, B, seed=B, dev=dev)
        got = lsthm_onlysp_recurrence_bidir(seqs, consts)
        torch.cuda.synchronize()
        want = lsthm_onlysp_recurrence_bidir_ref(seqs, consts)
        err = (got - want).abs().max().item()
        max_err = max(max_err, err)
        print(f"[kernel] B={B:3d} T=110 max|kernel-plain| = {err:.3e}")
        check(torch.isfinite(got).all().item(), f"non-finite kernel output B={B}")
        check(err <= 1e-4, f"kernel disagrees with plain version at B={B}")

    # 4. the main path: three requests through the Predictor
    spec = get_model_spec("MARN1_onlysp")
    eval_batch, n_utts = iemocap_eval_batch(seed=0)
    n0 = int(eval_batch["umask"][0].sum())  # dialogue 0 alone, unpadded
    one = {k: (v[:1, :n0] if k in ("umask", "label") else v[:n0, :1])
           for k, v in eval_batch.items() if k != "vid"}
    train_batch = synthetic_batch(L=110, B=80, seed=1, min_len=20)
    requests = [("iemocap_eval", eval_batch), ("one_dialogue", one),
                ("train_shape", train_batch)]

    gpu = Predictor(seed=0, device="cuda")
    cpu = Predictor(state_dict={k: v.cpu() for k, v in
                                gpu.model.state_dict().items()}, device="cpu")
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
        L, B = x.shape[:2]
        ref = cpu.predict(x, qmask, umask)[0]
        err = (logp - ref).abs().max().item()
        ok = torch.allclose(logp, ref, rtol=1e-3, atol=1e-4)
        print(f"[predict] {name}: L={L} B={B} logp {tuple(logp.shape)} "
              f"launches={launches} max|gpu-cpu|={err:.3e}")
        check(torch.isfinite(logp).all().item(), f"non-finite logp for {name}")
        check(tuple(logp.shape) == (B * L, 6), f"logp shape for {name}")
        check(launches == 1, f"{name} launched {NAME} {launches} times")
        check(ok, f"{name}: card and CPU disagree beyond rtol 1e-3, atol 1e-4")
    check(gpu.n_requests == 3, "the predictor did not count three requests")

    # 5. timings at the IEMOCAP eval shape
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
    for B_sweep in (1, 8, 31, 80):  # does the per-step time depend on B?
        s_in, c_in = recurrence_inputs(np, torch, 82, B_sweep, seed=7, dev=dev)
        ms = cuda_ms(torch, lambda: lsthm_onlysp_recurrence_bidir(s_in, c_in))
        print(f"[time] {card} | kernel T=82 B={B_sweep}: {ms:.4f} ms "
              f"({ms / 82 * 1e3:.2f} us/step)")
    bound_ms, bound_by = recurrence_bound(seqs, consts, out)
    T, _, B = seqs[0].shape[:3]
    print(f"[time] {card} | recurrence T={T} B={B}: kernel {kernel_ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    print(f"[time] {card} | predict {n_utts} utterances: {predict_ms:.4f} ms, "
          f"{n_utts / predict_ms * 1e3:.1f} utterances/s")

    # 6. where the time of a request goes: device time by kernel, and the
    #    device's busy share of the wall time, over five requests
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(5):
            gpu.predict(x, qmask, umask)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()  # kernels and copies, not host ops
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.key.startswith("Activity Buffer")]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(f"[profile] {card} | 5 requests: wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%)")
    for e in sorted(events, key=lambda e: e.self_device_time_total,
                    reverse=True)[:10]:
        if e.self_device_time_total > 0:
            print(f"[profile]   {e.self_device_time_total / 5e3:9.4f} ms/request "
                  f"x{e.count // 5:<4d} {e.key[:90]}")

    print(json.dumps({"kernels": [{
        "name": NAME, "route": "cuda",
        "source": "ser_tpu_torch/csrc/lsthm_onlysp.cu",
        "replaces": "ser_tpu/ops/pallas/lsthm.py:296",
        "launches": main_launches, "max_abs_err": max_err,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
