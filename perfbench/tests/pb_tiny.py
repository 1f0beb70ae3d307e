"""What the benchmark's CPU tests share: a root of their own for the test
cells (a copy of ``perfbench/`` with the CPU-size configurations, mixes
and workloads of ``tests/data`` added as files), and a run of a cell
there.  Not a ``conftest.py``: the repository's tests import theirs as
``conftest``, and a second module of that name would shadow it.  The
``cuda`` marker is the one ``tests/conftest.py`` registers."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
DATA = Path(__file__).resolve().parent / "data"
TINY = {"tiny-train-ep": ("tiny-moe", "tiny-train-ep"),
        "tiny-train-shoal": ("tiny-dense", "tiny-train-shoal"),
        "tiny-chat": ("tiny-moe", "tiny-chat")}


def make_root(path: Path) -> Path:
    """``path`` holding ``perfbench/`` (without its tests) and a
    ``BENCHMARK.json`` whose cells are the test cells, on the real
    benchmark's metrics and the serving driver's (``serving_metrics.json``,
    the entries of a serving cell, kept for the test cell while the
    benchmark has none)."""
    shutil.copytree(REPO / "perfbench", path / "perfbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    for kind in ("configs", "traffic", "workloads"):
        for f in (DATA / kind).iterdir():
            shutil.copy(f, path / "perfbench" / kind / f.name)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    serving = json.loads((DATA / "serving_metrics.json").read_text())
    for kind in ("end_to_end", "per_layer"):
        have = {m["name"] for m in bench[kind]}
        bench[kind] += [m for m in serving[kind] if m["name"] not in have]
    bench["configs"] = [{"name": n, "source": "test",
                         "file": f"perfbench/configs/{n}.json",
                         "reduced": [], "why": "test"}
                        for n in ("tiny-moe", "tiny-dense")]
    bench["workloads"] = [{"name": c, "config": cfg, "traffic": mix,
                           "chips": 1, "why": "test"}
                          for c, (cfg, mix) in TINY.items()]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            kind = "train" if "train" in m["workloads"][0] else "chat"
            m["workloads"] = ([c for c in TINY if kind in c]
                              if m["name"] != "sync_ms.train"
                              else ["tiny-train-shoal"])
    (path / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return path


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("perfbench_root"))


def run_cell(root: Path, cell: str, *, fault: str = "-", seed: int = 3,
             seconds: float = 0.5, trace: int = 0, timeout: float = 300):
    """``cpu_run.py`` in a fresh interpreter: ``(exit code, result or
    None, stderr)``."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).parent / "cpu_run.py"),
         str(root), fault, "--workload", cell, "--seed", str(seed),
         "--seconds", str(seconds), "--trace", str(trace)],
        capture_output=True, text=True, timeout=timeout, env=env)
    lines = proc.stdout.strip().splitlines()
    result = json.loads(lines[-1]) if proc.returncode == 0 and lines \
        else None
    return proc.returncode, result, proc.stderr
