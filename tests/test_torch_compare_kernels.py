"""``ser_tpu_torch.utils.compare_kernels`` on the CPU: the script runs the
named kernel's child script in turns (other, this, this, other), each with
its checkout's root and B, and prints each child's last line. The children
themselves need the card; here they are only compiled."""

from __future__ import annotations

import subprocess
from pathlib import Path

import pytest

from ser_tpu_torch.utils import compare_kernels

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("kernel", ["rank1", "lsthm"])
def test_compare_kernels_runs_the_named_child_in_turns(kernel, tmp_path, monkeypatch, capsys):
    compile(compare_kernels.CHILDREN[kernel], kernel, "exec")
    calls = []

    def fake_run(cmd, capture_output, text):
        calls.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, stdout=f"noise\n{{\"n\": {len(calls)}}}\n",
                                           stderr="")

    monkeypatch.setattr(compare_kernels.subprocess, "run", fake_run)
    assert compare_kernels.main([kernel, str(tmp_path), "--B", "31"]) == 0
    assert [c[2] for c in calls] == [compare_kernels.CHILDREN[kernel]] * 4
    assert [c[3] for c in calls] == [str(tmp_path), str(ROOT), str(ROOT), str(tmp_path)]
    assert all(c[4] == "31" for c in calls)
    assert capsys.readouterr().out.splitlines() == [f'{{"n": {i}}}' for i in range(1, 5)]


def test_compare_kernels_stops_at_a_failed_child(tmp_path, monkeypatch, capsys):
    calls = []

    def fake_run(cmd, capture_output, text):
        calls.append(cmd)
        return subprocess.CompletedProcess(cmd, 3, stdout="", stderr="no card")

    monkeypatch.setattr(compare_kernels.subprocess, "run", fake_run)
    assert compare_kernels.main(["lsthm", str(tmp_path)]) == 3
    assert len(calls) == 1 and "no card" in capsys.readouterr().err
