"""BENCHMARK.json against the benchmark's contract, and the harness's
isolation: nothing under benchmark/ imports JAX or the JAX package, and
the reference imports nothing of the program."""

import ast
import re
from pathlib import Path

import pytest

from benchmark.cell import HERE, ROOT, benchmark_file, load_json

BENCH = benchmark_file()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
METRIC_KEYS = {"name", "unit", "better", "source"}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert all(re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) for p in BENCH["paths"])


def test_names_units_and_lines():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE.match(c["source"]) and LINE.match(c["why"])
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert LINE.match(w["why"]) and w["chips"] == 1 and w["config"] in names
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert LINE.match(m["layer"])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    all_names = [x["name"] for x in metrics + BENCH["workloads"] + BENCH["configs"]]
    assert len(all_names) == len(set(all_names))
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    for p in HERE.rglob("*"):
        if "__pycache__" not in p.parts:
            assert re.fullmatch(r"[A-Za-z0-9_./-]+", str(p.relative_to(ROOT))), p


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_has_its_files_and_metrics(workload):
    w = next(x for x in BENCH["workloads"] if x["name"] == workload)
    assert (HERE / "traffic" / f"{w['traffic']}.json").is_file()
    limits = load_json(HERE / "limits" / f"{workload}.json")
    assert limits and all(v >= 0 for v in limits.values())
    e2e = {m["name"] for m in BENCH["end_to_end"] if workload in m.get("workloads", [workload])}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = [m for m in BENCH["per_layer"] if workload in m.get("workloads", [])]
    assert layer and all(m["moves"] in e2e for m in layer)
    for m in BENCH["per_layer"]:
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()


def imports(path: Path):
    """Top-level names a Python file imports."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_jax_anywhere_and_a_plain_reference():
    for path in HERE.rglob("*.py"):
        found = set(imports(path))
        assert not found & {"jax", "jaxlib", "flax", "ser_tpu"}, path
        if "reference" in path.parts:
            assert "ser_tpu_torch" not in found, path
