"""Time one kernel of two checkouts in turns on one card.

    python -m ser_tpu_torch.utils.compare_kernels {rank1,lsthm} OTHER_ROOT [--B 80]

OTHER_ROOT is another checkout of the repository, for example an earlier
commit unpacked with ``git archive``. The two run in turns, other, this,
this, other, each in a process of its own that builds its kernel from its
own sources and prints one JSON line. Compare the two only within one run:
cards and hosts differ between runs.

- ``rank1``: at [2, B, 128], p = 0.2, the forward's and the backward's
  device time (calls captured in a CUDA graph), their wrapper-call time
  (CUDA events), and the host time of a forward and backward pair through
  autograd (``perf_counter`` over 500 pairs).
- ``lsthm``: the recurrence kernel at the IEMOCAP eval shape (T = 82,
  B = 31, two parties), its device time (CUDA graph) and its wrapper-call
  time (CUDA events), and, where the checkout's kernel takes nine parties,
  the same at the MELD request shape (T = 32, B = 80). ``--B`` is not read.

Inputs are ``chip_smoke``'s, seeded.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

# run in the checkout under test, with its own chip_smoke.py's timers and
# inputs; argv: the checkout's root, B
CHILDREN = {"rank1": r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke as cs
from ser_tpu_torch.ops.kernels import rank1

B, p = int(sys.argv[2]), 0.2
dev = torch.device("cuda:0")
x1, x2, wq, wk, gz = cs.rank1_inputs(torch, B, dev, seed=5)
seed = torch.tensor([20240611], dtype=torch.int32, device=dev)
if hasattr(rank1, "Rank1Kernel"):
    kernel = rank1.Rank1Kernel(wq, wk, seed, p)
    fwd = lambda: kernel.forward(x1, x2, 3)
    bwd = lambda: kernel.backward(x1, x2, 3, gz)
else:  # the kernel before the binding object
    fwd = lambda: rank1._launch_fwd(x1, x2, wq, wk, seed, 3, p)
    bwd = lambda: rank1._launch_bwd(x1, x2, wq, wk, seed, 3, p, gz)
xs = [t.clone().requires_grad_() for t in (x1, x2, wq, wk)]
pair = lambda: torch.autograd.grad(rank1.rank1_attention(*xs, seed, 3, p), xs, gz)
pair()
torch.cuda.synchronize()
t0 = time.perf_counter()
for _ in range(500):
    pair()
host_us = (time.perf_counter() - t0) / 500 * 1e6
torch.cuda.synchronize()
print(json.dumps({"root": sys.argv[1], "fwd_device_ms": cs.cuda_graph_ms(torch, fwd),
                  "bwd_device_ms": cs.cuda_graph_ms(torch, bwd),
                  "fwd_call_ms": cs.cuda_ms(torch, fwd, iters=50),
                  "bwd_call_ms": cs.cuda_ms(torch, bwd, iters=50),
                  "pair_host_us": host_us}))
""", "lsthm": r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
import chip_smoke as cs
from ser_tpu_torch.device import disable_tf32
from ser_tpu_torch.ops.kernels import lsthm

disable_tf32()
dev = torch.device("cuda:0")
out = {"root": sys.argv[1]}
shapes = {"p2": (82, 31, {})}
if 9 in getattr(lsthm, "PARTIES", ()):
    shapes["p9"] = (32, 80, {"P": 9})
for name, (T, B, kw) in shapes.items():
    seqs, consts = cs.recurrence_inputs(np, torch, T, B, seed=7, dev=dev, **kw)
    run = lambda: lsthm.lsthm_onlysp_recurrence_bidir(seqs, consts)
    out[f"{name}_device_ms"] = cs.cuda_graph_ms(torch, run)
    out[f"{name}_call_ms"] = cs.cuda_ms(torch, run, iters=50)
print(json.dumps(out))
"""}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("kernel", choices=sorted(CHILDREN))
    ap.add_argument("other", help="root of the other checkout")
    ap.add_argument("--B", type=int, default=80)
    args = ap.parse_args(argv)
    this = str(Path(__file__).resolve().parents[2])
    for root in (args.other, this, this, args.other):
        out = subprocess.run([sys.executable, "-c", CHILDREN[args.kernel],
                              str(Path(root).resolve()), str(args.B)],
                             capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stderr[-3000:], file=sys.stderr)
            return out.returncode
        print(out.stdout.strip().splitlines()[-1])
    return 0


if __name__ == "__main__":
    sys.exit(main())
