"""Readings for a cell's limits: the numbers a run compares, on many seeds
in one process, for the program as it is (``sound``), for the control
(``tf32``: the program with TF32 on, the precision next below the
configuration's f32) and for each planted fault (``benchmark.faults``).

    python3 -m benchmark.calibrate --workload NAME --mode sound --seeds 1,2,3 --seconds 2

One JSON line a seed. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json

from benchmark import faults
from benchmark.cell import load_cell
from benchmark.run import build_dirs, execute


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--mode", default="sound",
                   choices=("sound", "tf32", *faults.TRAIN, *faults.SCORE))
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    build_dirs()
    cell = load_cell(args.workload)
    import torch

    plant = {**faults.TRAIN, **faults.SCORE}.get(args.mode)
    for seed in (int(s) for s in args.seeds.split(",")):
        result, notes = execute(cell, seed, args.seconds, 0, torch, args.device,
                                plant=plant, tf32=args.mode == "tf32")
        print(json.dumps({"workload": args.workload, "mode": args.mode, "seed": seed,
                          "correct": result["correct"], "failed": result["failed"],
                          "compared": {k: v["value"] for k, v in result["compared"].items()},
                          "notes": notes}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
