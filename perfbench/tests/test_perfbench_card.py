"""Every cell of BENCHMARK.json on the card, briefly, with ``correct``
true (the ``cuda`` marker: skipped without a card)."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]


@pytest.mark.cuda
def test_cells_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the cells run on the H100")
    cells = [w["name"] for w in
             json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]
    for cell in cells:
        proc = subprocess.run(
            [sys.executable, "perfbench/run.py", "--workload", cell,
             "--seed", "2147483711", "--seconds", "3", "--trace", "0"],
            cwd=REPO, capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr[-3000:]
        assert json.loads(proc.stdout.strip().splitlines()[-1])["correct"]
