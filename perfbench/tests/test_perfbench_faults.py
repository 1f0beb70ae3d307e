"""Each fault a test cell can have, planted underneath the timed path,
turns ``correct`` false; the fp8 control put in the program's place
fails a check of every test cell."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
from pb_tiny import REPO, run_cell, tiny_root  # noqa: F401

CASES = [("tiny-train-ep", f) for f in ("unchanged", "half_batch",
                                        "no_exchange")] + \
    [("tiny-train-shoal", f) for f in ("unchanged", "half_batch",
                                       "no_exchange")] + \
    [("tiny-chat", f) for f in ("half_batch", "token")]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_not_correct(tiny_root, cell, fault):
    rc, res, err = run_cell(tiny_root, cell, fault=fault, seconds=0.3)
    assert rc == 0, err[-3000:]
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("cell", ["tiny-train-ep", "tiny-train-shoal",
                                  "tiny-chat"])
def test_control_fails_a_check(tiny_root, cell):
    import json

    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, str(Path(tiny_root) / "perfbench" / "control.py"),
         "--workload", cell, "--seeds", "4,5", "--as", "control",
         "--device", "cpu", "--seconds", "1"],
        capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    summary = json.loads(proc.stdout.strip().splitlines()[-1])["summary"]
    limits = json.loads((Path(tiny_root) / "perfbench" / "workloads"
                         / f"{cell}.json").read_text())["limits"]
    assert any(summary[k] > limits[k] for k in limits), summary
