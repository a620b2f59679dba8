"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m benchmark.run --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout, on a machine with the cards the cell asks
for. The program under test is ``ser_tpu_torch``; the run imports neither
``jax`` nor the JAX package, and checks at its end that neither is loaded.
It sets up (``setup_s``, from the process's start to the window's), runs a
closed-loop window of S seconds, checks what the window produced against
the benchmark's reference, and prints one JSON line: with ``--trace 0`` the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics from a
profiled slice after the window. The numbers compared, each with its limit,
end both its standard error and its result line.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import resource
import sys
import time

from benchmark.cell import ROOT, load_cell, read_metric

FORBIDDEN = ("jax", "jaxlib", "flax", "ser_tpu")


def process_age() -> float:
    """Seconds since this process started, on the boot clock."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start_ticks / os.sysconf("SC_CLK_TCK")


def host_snapshot() -> dict:
    """What says how fast this process's host ran: this process's CPU time
    and the seconds of a fixed pure-Python loop."""
    usage = resource.getrusage(resource.RUSAGE_SELF)
    wall = time.perf_counter()
    sum(i * i for i in range(1_000_000))
    return {"wall": wall, "probe_s": time.perf_counter() - wall,
            "cpu_s": usage.ru_utime + usage.ru_stime}


def host_line(before: dict, after: dict) -> str:
    """One line on the host around the window, from two snapshots."""
    share = (after["cpu_s"] - before["cpu_s"]) / (after["wall"] - before["wall"])
    return (f"host {os.uname().nodename}, {os.cpu_count()} cpus: in the window this process "
            f"ran {share:.3f} of the wall clock; a fixed Python loop took "
            f"{1e3 * before['probe_s']:.2f} ms before it and {1e3 * after['probe_s']:.2f} after")


def build_dirs() -> None:
    """Kernel caches inside the checkout, at fixed paths (the program's own
    nvcc builds already go to ``build/kernels``)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ.setdefault(var, str(ROOT / "build" / sub))


class Context:
    """What a driver asks of the run: the device, the clock of set-up, the
    memory peak, and ``plant``, a hook on the program object that the
    benchmark's tests and calibration use to plant a fault (None in a run)."""

    def __init__(self, torch, device, plant=None):
        self.torch, self.device = torch, torch.device(device)
        self.on_device = self.device.type == "cuda"
        self.plant = plant or (lambda program: None)
        self.setup_s = None
        self.phases = []
        self.host = []

    def phase(self, name: str):
        """Mark the end of a set-up phase (printed to standard error)."""
        self.phases.append((name, process_age()))

    def synchronize(self):
        if self.on_device:
            self.torch.cuda.synchronize()

    def memory_peak(self, reset=False) -> int:
        """The most memory allocated since the last reset; with ``reset``,
        the allocated and the reserved peaks start again from now."""
        if not self.on_device:
            return 0
        peak = self.torch.cuda.max_memory_allocated(self.device)
        if reset:
            self.torch.cuda.reset_peak_memory_stats(self.device)
        return peak

    def reserved_peak(self) -> int | None:
        """The most memory the allocator held from the card since the last
        reset: the allocated peak's blocks, its cache and the CUDA graphs'
        private pools. None off the card."""
        if not self.on_device:
            return None
        return self.torch.cuda.max_memory_reserved(self.device)

    def window_opens(self):
        self.host = [host_snapshot()]
        self.setup_s = process_age()
        self.phases.append(("warm-up", self.setup_s))

    def window_closes(self):
        self.host.append(host_snapshot())

    def free(self):
        if self.on_device:
            self.torch.cuda.empty_cache()


def set_precision(torch, tf32: bool) -> None:
    """f32 products and convolutions in full f32 (the configuration's
    precision), or in TF32 for the control."""
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def execute(cell, seed, seconds, trace, torch, device, plant=None, tf32=False):
    """One run of ``cell``: ``(result line, notes)``. ``plant`` and ``tf32``
    are the calibration's and the tests' faults and control."""
    set_precision(torch, tf32)
    ctx = Context(torch, device, plant)
    ctx.phase("imports")
    out = cell.driver.run(cell, seed, seconds, bool(trace), ctx)
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if trace:
        values = {m["name"]: read_metric(m["name"], out.readings) for m in cell.per_layer}
    else:
        values = {**out.e2e, "setup_s": ctx.setup_s}
        missing = [m["name"] for m in cell.end_to_end if m["name"] not in values]
        if missing:
            raise RuntimeError(f"the {cell.traffic['driver']} driver measures no {missing}")
    metrics = {name: {"value": v, "unit": units[name]} for name, v in values.items()
               if name in units and v is not None}
    compared = {name: {"value": v if math.isfinite(v) else float("inf"),
                       "limit": cell.limits[name]} for name, v in out.compared.items()}
    correct = (out.attempted > 0 and out.failed == 0
               and all(c["value"] <= c["limit"] for c in compared.values()))
    device_info = {"platform": "gpu" if ctx.on_device else "cpu",
                   "kind": torch.cuda.get_device_name(ctx.device) if ctx.on_device else "cpu",
                   "count": 1, "memory_peak_bytes": out.memory_peak_bytes}
    result = {"correct": correct, "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics, "device": device_info}
    if trace and out.readings.trace is not None:
        t = out.readings.trace
        device_info.update(busy_s=t.busy_s, window_s=t.window_s)
        result["breakdown"] = {"device_ops": t.top_device_ops(), "idle_gaps": t.idle_gaps()}
    result["compared"] = compared
    notes = {**out.notes, "phases": ctx.phases}
    if len(ctx.host) == 2:
        notes["host"] = host_line(*ctx.host)
    return result, notes


def loaded_forbidden() -> list[str]:
    """Modules of ``FORBIDDEN`` in ``sys.modules``, by whole top-level name."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    build_dirs()
    cell = load_cell(args.workload)
    import torch

    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, notes = execute(cell, args.seed, args.seconds, args.trace, torch, "cuda")
    found = loaded_forbidden()
    if found:
        print(f"loaded in this process: {', '.join(found)}; the benchmark must not "
              "load JAX or the JAX package", file=sys.stderr)
        return 3
    print("set-up phases, s since the process started: " + ", ".join(
        f"{name} {t:.3f}" for name, t in notes["phases"]), file=sys.stderr)
    print(notes.get("host", "host not read"), file=sys.stderr)
    if "thirds" in notes:
        print("the window's rate by thirds: " + ", ".join(f"{r:.1f}" for r in notes["thirds"]),
              file=sys.stderr)
    for name, c in result["compared"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
