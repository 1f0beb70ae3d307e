"""Whole runs of the harness on the CPU, in fresh interpreters, at the
test cells: the result line, the traced run, a cell and a metric added
as files alone, and the refusal to print once a module of JAX or of the
JAX package is loaded."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
from pb_tiny import TINY, run_cell, tiny_root  # noqa: F401

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell", list(TINY))
def test_sound_run_is_correct(tiny_root, cell):
    rc, res, err = run_cell(tiny_root, cell, seed=2 ** 31 + 7)
    assert rc == 0, err[-3000:]
    assert list(res) == KEYS + ["checks"]
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    assert "setup_s" in res["metrics"] and len(res["metrics"]) >= 2
    assert res["device"]["count"] == 1
    # the checks, each beside its limit, are the last lines on stderr
    tail = err.strip().splitlines()[-len(res["checks"]):]
    assert [line.split()[1] for line in tail] == list(res["checks"])


@pytest.mark.parametrize("cell", list(TINY))
def test_traced_run_reads_its_layers(tiny_root, cell):
    rc, res, err = run_cell(tiny_root, cell, trace=1)
    assert rc == 0, err[-3000:]
    assert list(res) == KEYS + ["breakdown", "checks"]
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    # on the CPU the device's readings stay silent, the spans do not
    got = set(res["metrics"])
    assert not {n for n in got if n.startswith(("mfu", "idle", "flash",
                                                "ring"))}
    want = ({"fwd_bwd_ms.train", "adamw_ms.train",
             "exchanges_per_step.train"} if "train" in cell else
            {"prefill_ms.serve", "decode_step_ms.serve"})
    assert want <= got
    assert ("sync_ms.train" in got) == (cell == "tiny-train-shoal")


def test_cell_and_metric_added_as_files(tiny_root, tmp_path):
    root = tmp_path / "root"
    shutil.copytree(tiny_root, root)
    (root / "perfbench" / "metrics" / "steps_seen.train.py").write_text(
        "def read(rec):\n    return float(rec['span_steps'])\n")
    for kind in ("traffic", "workloads"):
        shutil.copy(root / "perfbench" / kind / "tiny-train-ep.json",
                    root / "perfbench" / kind / "tiny-train-ep-b.json")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tiny-train-ep-b",
                               "config": "tiny-moe",
                               "traffic": "tiny-train-ep-b", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_tokens_per_s":
            m["workloads"].append("tiny-train-ep-b")
    bench["per_layer"].append({"name": "steps_seen.train", "unit": "count",
                               "better": "higher", "source": "program_span",
                               "layer": "trainer",
                               "moves": "train_tokens_per_s",
                               "workloads": ["tiny-train-ep-b"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    rc, res, err = run_cell(root, "tiny-train-ep-b", trace=1)
    assert rc == 0, err[-3000:]
    assert res["metrics"]["steps_seen.train"]["value"] == 1.0


@pytest.mark.parametrize("module,refused", [("repro", True),
                                            ("jax", True),
                                            ("repro_torchish", False)])
def test_loaded_jax_is_refused(tiny_root, module, refused):
    rc, res, err = run_cell(tiny_root, "tiny-chat", fault=f"module:{module}")
    assert (rc != 0 and res is None) == refused, err[-2000:]
    if refused:
        assert module in err


def test_refused_without_the_program(tiny_root):
    """A directory with BENCHMARK.json and perfbench/ alone: no result."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).parent / "cpu_run.py"),
         str(tiny_root), "-", "--workload", "tiny-chat", "--seed", "1",
         "--seconds", "0.3"], capture_output=True, text=True, timeout=300,
        env=env, cwd=tiny_root)
    assert proc.returncode != 0
    assert not proc.stdout.strip()
