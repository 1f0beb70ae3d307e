"""BENCHMARK.json against the rules of its format (keys, names, units,
bounds, what every cell reports), and every cell, mix, workload and
metric it names found by name."""

import json
import re
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from perfbench import bench  # noqa: E402

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTH = re.compile(r"(hidden|intermediate|latent|state|proj|_dim$|_rank$|"
                   r"head|expan|d_model|d_ff|top_k|experts_per|width)")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_run_seconds_fit_the_full_check():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_entries_have_the_format_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (REPO / c["file"]).is_file()
        assert c["file"].startswith("perfbench/")
        assert len(c["reduced"]) <= 16
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200


def test_names_units_and_sources():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for c in BENCH["configs"]:
        for key in c["reduced"]:
            assert NAME.match(key) and not WIDTH.search(key), key


def test_every_cell_reports_setup_another_metric_and_a_layer():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(
        1, len(CELLS) // 4)
    for cell in CELLS:
        c = bench.load_cell(REPO, cell)
        names = {m["name"] for m in c.end_to_end}
        assert "setup_s" in names and len(names) >= 2, cell
        assert c.per_layer, cell
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS
            scope = e2e[m["moves"]].get("workloads", CELLS)
            assert cell in scope, (m["name"], cell)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c = bench.load_cell(REPO, cell)
    assert callable(c.driver().run)
    assert c.checks["limits"]
    assert set(bench.family_module(c, "reference").__dict__) >= {
        "forward", "leaf_specs", "loss_and_grads"}
    assert callable(bench.family_module(c, "layouts").port_tree)
    for m in c.per_layer:
        assert callable(c.reader(m["name"]).read), m["name"]


@pytest.mark.parametrize("metric", sorted(
    f.stem for f in (REPO / "perfbench" / "metrics").glob("*.py")))
def test_reader_is_silent_on_the_other_kind(metric):
    reader = bench.load_module(REPO / "perfbench" / "metrics"
                               / f"{metric}.py", "reader")
    kind = "serve" if metric.endswith(".train") else "train"
    rec = {"kind": kind, "platform": "cuda", "dtype": "bfloat16",
           "window_s": 1.0, "window_flops": 1e12, "spans": {}, "calls": {},
           "span_steps": 1, "exchanges_per_step": 1.0, "ring_bytes": 1,
           "flash_bound_s": 1e-3,
           "profile": {"busy_s": 0.5, "window_s": 1.0, "kernels": {}}}
    assert reader.read(rec) is None


# published key -> the configuration file's key, for every width
PUBLISHED = {"d_model": "d_model", "hidden_size": "d_model",
             "n_heads": "n_heads", "num_attention_heads": "n_heads",
             "kv_n_heads": "n_kv_heads", "num_key_value_heads": "n_kv_heads",
             "intermediate_size": "d_ff", "vocab_size": "vocab",
             "ffn_hidden_size": ("moe", "d_ff_expert"),
             "moe_num_experts": ("moe", "n_experts"),
             "moe_top_k": ("moe", "top_k"), "rope_theta": "rope_base",
             "tie_word_embeddings": "tie_embeddings"}


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_keeps_every_published_width(entry):
    cfg = json.loads((REPO / entry["file"]).read_text())
    assert cfg["name"] == entry["name"]
    assert sorted(cfg["reduced"]) == sorted(entry["reduced"])
    m = cfg["model"]
    for key, value in cfg["published"].items():
        ours = PUBLISHED.get(key)
        if ours is None:
            continue
        got = m[ours[0]][ours[1]] if isinstance(ours, tuple) else m[ours]
        assert got == value, (key, got, value)
    layers = cfg["published"].get("n_layers",
                                  cfg["published"].get("num_hidden_layers"))
    assert (m["n_layers"] == layers) == ("n_layers" not in cfg["reduced"])
    moe = m.get("moe")
    if moe:     # dropless: every routed pair fits the capacity
        assert moe["capacity_factor"] * moe["top_k"] >= moe["n_experts"]


def test_forbidden_modules_compare_whole_names(monkeypatch):
    before = bench.forbidden_modules()
    for name in ("repro_torch_extra", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, object())
    assert bench.forbidden_modules() == before
    monkeypatch.setitem(sys.modules, "repro.models", object())
    assert "repro.models" in bench.forbidden_modules()
