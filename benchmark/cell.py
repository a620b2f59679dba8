"""A cell of ``BENCHMARK.json`` and the files it is made of, found by name.

A workload names a configuration and a traffic mix. The configuration is
``benchmark/configs/<config>.json`` (its widths, the program's model name
and the reference module, ``benchmark/reference/<reference>.py``); the
traffic mix is ``benchmark/traffic/<traffic>.json``, whose ``driver`` names
the module that drives it (``benchmark/<driver>.py``); the limits of the
cell's check are ``benchmark/limits/<workload>.json``; a per-layer metric is
``benchmark/metrics/<metric>.py``. A later cell adds files and entries and
edits none of these.

A configuration of any family the program's registry holds joins through
its own files:

- ``configs/<config>.json`` (the configuration's ``file``): ``model``, the
  program's registry name; ``reference``, the module below; ``classes`` and
  ``parties``; the widths that ``generate`` draws, ``text_views``,
  ``text_width``, ``audio_width`` and, for a model that reads ``visuf``,
  ``visual_width``; ``input_width``, the width of the reference's x;
  ``dropout``, each rate of the program's model by the reference's groups;
  ``precision``; and whatever else its ``config_checks`` read (MARN1's:
  ``modality_width``, ``hidden``, ``encoder``, ``head``);
- ``reference/<reference>.py``, plain PyTorch that imports nothing of the
  program: ``param_table(n_classes)``, every parameter under the program's
  state-dict name (``common.ParamTable``; the program loads it strictly);
  ``forward(P, x, qmask, umask)``, log-probabilities ``[B*L, C]`` in the
  rows' order of the program's output; ``inputs(batch, config)``, x in
  float64 from a batch's tensors (MARN1's is ``common.marn1_inputs``, the
  text views' mean, then the audio), which ``common.reference_input`` calls
  for both drivers; ``SMOOTH_LEAVES``, the leaves between the loss and the
  last ReLU; ``matmul_flops(L, B, train)``, what ``FlopCounterMode``
  counts in ``forward`` (and in a train step's backward);
  ``config_checks(config)``, ``(what, one side, the other)`` triples that
  are equal where the file agrees with the reference;
  ``dropout_group(name)``, the ``dropout`` key of a program module's rate
  (``<module>`` for a ``Dropout``, ``<module>.dropout_rate`` or
  ``<module>.attn_dropout`` for a float rate); ``ENCODERS``, optional, the
  encoder layers that ``forward`` runs through ``common.encoder``, each
  ``encoder.passes`` times (none without it); ``rank1_calls(L, train)``,
  optional, for the rank-1 kernel's roofline;
- a cell of it: its entry under ``workloads``, named ``<...>.train.<...>``
  or ``<...>.score.<...>`` by its driver, in the ``workloads`` lists of its
  metrics, and ``limits/<workload>.json``, a limit for each number that
  its driver compares (``compare``).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_file() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    reference: object
    end_to_end: list
    per_layer: list

    @property
    def driver(self):
        return importlib.import_module(f"benchmark.{self.traffic['driver']}")


def load_cell(name: str, bench: dict | None = None, traffic: dict | None = None) -> Cell:
    """The cell ``name`` of ``bench`` (``BENCHMARK.json`` by default), with
    ``traffic`` in place of its traffic file where given (the tests' small
    sizes)."""
    bench = benchmark_file() if bench is None else bench
    workloads = {w["name"]: w for w in bench["workloads"]}
    if name not in workloads:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json; "
                         f"there are {sorted(workloads)}")
    w = workloads[name]
    config = load_json(ROOT / next(c["file"] for c in bench["configs"]
                                   if c["name"] == w["config"]))
    if traffic is None:
        traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    limits = load_json(HERE / "limits" / f"{name}.json")
    reference = importlib.import_module(f"benchmark.reference.{config['reference']}")
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    layer = [m for m in bench["per_layer"] if name in m["workloads"]]
    return Cell(name, w, config, traffic, limits, reference, e2e, layer)


def read_metric(metric: str, readings) -> float | None:
    """The value of the per-layer ``metric`` from its reader's file."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics._" + metric.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(readings)


def rate_by_thirds(ends: list, per_item: float) -> list:
    """The window's rate in each third: items (epochs, requests) of
    ``per_item`` utterances over the time between the last ends at or
    before each third's close (``ends``: seconds from the window's start).
    Empty for fewer than three items."""
    if len(ends) < 3:
        return []
    out, done, since = [], 0, 0.0
    for k in (1, 2, 3):
        n = max(sum(t <= ends[-1] * k / 3 for t in ends), done + 1)
        out.append(per_item * (n - done) / (ends[n - 1] - since))
        done, since = n, ends[n - 1]
    return out


@dataclass
class Readings:
    """What a per-layer reader reads. ``trace`` is the traced slice
    (``benchmark.trace.Trace``) and ``slice_shapes`` the [L, B] of each step
    or request in it; ``timed_shapes`` and ``timed_s`` are the untraced part
    of the window. ``on_device``: whether the run's times are the card's.
    ``reserved_peak_bytes``: ``torch.cuda.max_memory_reserved`` from the
    window's opening to the end of the traced slice, None off the card."""

    trace: object = None
    slice_shapes: list = field(default_factory=list)
    timed_shapes: list = field(default_factory=list)
    timed_s: float = 0.0
    reference: object = None
    config: dict = field(default_factory=dict)
    on_device: bool = False
    reserved_peak_bytes: int | None = None


@dataclass
class Outcome:
    """A driver's result: the cell's end-to-end metrics (all it measures),
    the readings of its traced slice, the counts, the numbers compared with
    the reference (name -> value), the device's memory peak, and what the
    calibration prints beside the numbers compared (the worst leaves)."""

    e2e: dict
    readings: Readings
    attempted: int
    failed: int
    compared: dict
    memory_peak_bytes: int
    notes: dict = field(default_factory=dict)
