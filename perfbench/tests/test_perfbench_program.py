"""The program-traced pass (``perfbench/program_trace.py``) and its
readers on the CPU: the attribution of device and idle time to span
paths on a synthetic trace, the readers on a synthetic record
(``data/program_record.json``), the pass at the test cells (the ring
bytes ``ShoalContext`` counts against ``RingBytes``' count, the MoE
dispatch's counts against a hand count), and the traced runs printing
the new metrics beside every metric they printed before."""

import copy
import dataclasses
import json
import sys
from pathlib import Path

import pytest
import torch
from pb_tiny import TINY, run_cell, tiny_root  # noqa: F401

REPO = Path(__file__).resolve().parents[2]
DATA = Path(__file__).resolve().parent / "data"
sys.path.insert(0, str(REPO))
sys.path.insert(1, str(REPO / "src"))

from perfbench import bench, program_trace  # noqa: E402

RECORD = json.loads((DATA / "program_record.json").read_text())
NEW = list(RECORD["want"])
DEVICE = [n for n in NEW if n != "expert_slot_fill.train"]
US = 1000                                    # ns a unit of the trace below


def reader(name):
    return bench.load_module(REPO / "perfbench" / "metrics" / f"{name}.py",
                             f"test_metric_{name}")


# --------------------------------------------------------------------------
# attribution, on a synthetic trace of two threads (M the caller, W
# autograd's), one step over the window [0, 1000) us
# --------------------------------------------------------------------------

M, W = 1, 2
STEP = "train.step"
FWD = f"{STEP}/model.forward"
ATT = f"{FWD}/model.attention"
BWD = f"{STEP}/model.backward"
RECOMPUTE = f"{BWD}/model.attention[recompute]"
GRAD = f"{BWD}/model.attention[grad]"
ADAMW = f"{STEP}/optim.adamw"


def synthetic_trace():
    def us(*xs):
        return [x * US for x in xs]

    spans = [(0, None, STEP, M, *us(0, 1000)),
             (1, 0, FWD, M, *us(10, 300)),
             (2, 1, ATT, M, *us(20, 150)),
             (3, 0, BWD, M, *us(300, 800)),
             (4, 3, RECOMPUTE, W, *us(320, 400)),
             (5, 0, ADAMW, M, *us(800, 990))]
    acts = [(*us(30, 60), M, 25 * US),       # the forward's attention
            (*us(50, 80), M, 40 * US),       # overlaps the one before by 10
            (*us(340, 360), W, 330 * US),    # the recompute
            (*us(430, 470), W, 425 * US),    # node of the attention's op
            (*us(530, 560), W, 525 * US),    # node of an op outside it
            (*us(640, 650), W, 630 * US),    # node of no forward op
            (*us(820, 900), M, 810 * US),    # AdamW
            (*us(910, 920), None, None),     # launch not found
            (*us(950, 1200), M, 960 * US)]   # runs past the window
    nodes = [(W, *us(420, 500), (M, 7)), (W, *us(520, 600), (M, 9)),
             (W, *us(620, 700), (M, 99))]
    fwd = {(M, 7): 50 * US, (M, 9): 200 * US}
    blocking = [(M, 850 * US, 5), (M, 860 * US, 5),      # one operation
                (W, 440 * US, ("call", 77)), (M, 5 * US, ("call", 78)),
                (M, 1100 * US, ("call", 79))]            # after the window
    return {"spans": spans, "acts": acts, "nodes": nodes, "fwd": fwd,
            "blocking": blocking, "skew": 0}


def test_attribution_adds_up_on_a_synthetic_trace():
    got = program_trace.attribute(synthetic_trace(), (0, 1000 * US), 1)
    ms = 1e-3                                 # one synthetic us in ms
    device = {p: v["device_ms"] / ms for p, v in got["paths"].items()
              if v["device_ms"]}
    idle = {p: v["idle_ms"] / ms for p, v in got["paths"].items()
            if v["idle_ms"]}
    assert device == pytest.approx({ATT: 50, RECOMPUTE: 20, GRAD: 40,
                                    BWD: 40, ADAMW: 130})
    assert idle == pytest.approx({STEP: 30, ATT: 260, RECOMPUTE: 70,
                                  GRAD: 60, BWD: 250, ADAMW: 40})
    assert got["busy_ms"] / ms == pytest.approx(290)
    assert got["device_outside_ms"] / ms == pytest.approx(10)
    assert got["idle_outside_ms"] == 0
    assert sum(device.values()) + 10 == pytest.approx(290)
    assert sum(idle.values()) == pytest.approx(1000 - 290)
    assert got["host_syncs"] == {ADAMW: 1, GRAD: 1, STEP: 1}
    assert got["host_syncs_per_step"] == 3
    assert {p: v["calls"] for p, v in got["paths"].items()
            if v["calls"]} == {STEP: 1, FWD: 1, ATT: 1, BWD: 1,
                               RECOMPUTE: 1, ADAMW: 1}
    halves = program_trace.attribute(synthetic_trace(), (0, 1000 * US), 2)
    assert halves["paths"][ADAMW]["device_ms"] == pytest.approx(
        got["paths"][ADAMW]["device_ms"] / 2)
    assert halves["paths"][ADAMW]["calls"] == 0.5


# --------------------------------------------------------------------------
# the readers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", NEW)
def test_reader_on_a_synthetic_record(name):
    read = reader(name).read
    assert read(copy.deepcopy(RECORD["train"])) == pytest.approx(
        RECORD["want"][name])
    cpu = copy.deepcopy(RECORD["train"])
    cpu["platform"] = cpu["program"]["platform"] = "cpu"
    assert read(cpu) == (None if name in DEVICE else RECORD["want"][name])
    assert read(copy.deepcopy(RECORD["serve"])) is None


@pytest.mark.parametrize("name", NEW)
def test_reader_silent_without_the_spans_module(name, monkeypatch):
    """A program without ``repro_torch.runtime.spans``: no pass, no
    reading, no error."""
    real = program_trace.importlib.util.find_spec
    monkeypatch.setattr(program_trace.importlib.util, "find_spec",
                        lambda n, *a: None if n.endswith(".spans")
                        else real(n, *a))
    rec = {k: v for k, v in copy.deepcopy(RECORD["train"]).items()
           if k != "program"}
    assert reader(name).read(rec) is None and rec["program"] is None


# --------------------------------------------------------------------------
# the pass at the test cells
# --------------------------------------------------------------------------

@pytest.mark.parametrize("cell", ["tiny-train-ep", "tiny-train-shoal"])
def test_pass_counts_ring_bytes_as_the_harness(tiny_root, cell):
    prog = program_trace.run_pass(bench.load_cell(tiny_root, cell), 11,
                                  torch.device("cpu"))
    assert prog["ring_bytes_harness"] > 0
    assert sum(prog["ring_bytes"].values()) == prog["ring_bytes_harness"]
    assert prog["ring_bytes"]["all_to_all"] == 0
    assert prog["busy_ms"] == 0 and prog["launches_located"] is None
    idle = sum(v["idle_ms"] for v in prog["paths"].values())
    assert idle + prog["idle_outside_ms"] == pytest.approx(
        prog["window_ms"])
    assert prog["paths"]["train.step"]["calls"] == 1
    member = "train.step/train.member/" if cell.endswith("shoal") else \
        "train.step/"
    assert f"{member}model.forward/model.attention" in prog["paths"]
    assert ("train.step/train.sync" in prog["paths"]) == \
        cell.endswith("shoal")


def _routes(monkeypatch):
    from repro_torch.models import moe

    seen, real = [], moe._route

    def route(router_w, x, dims):
        out = real(router_w, x, dims)
        seen.append(out[1])
        return out

    monkeypatch.setattr(moe, "_route", route)
    return seen


@pytest.mark.parametrize("cf,skew", [(2.0, 0.0), (0.5, 8.0)])
def test_moe_counts_match_a_hand_count(cf, skew, monkeypatch):
    """tiny-moe's island (psum over 2 kernels), and at a capacity factor
    under E / k with a router skewed to expert 0, where pairs drop."""
    from repro_torch.core.state import ShoalContext
    from repro_torch.models.model import build_model
    from repro_torch.models.moe import ExpertMesh
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import spans
    from repro_torch.training import Trainer

    cfg = bench.port_config(json.loads(
        (DATA / "configs" / "tiny-moe.json").read_text()))
    cfg = dataclasses.replace(cfg, remat="none", moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf))
    ctx = ShoalContext(2, device="cpu")
    model = build_model(cfg, device="cpu", ep=ExpertMesh(ctx))
    params = model.init(torch.Generator().manual_seed(3))
    for seg in params["segments"]:
        seg["b0_moe"]["moe"]["router"][..., 0] += skew
    g = torch.Generator().manual_seed(4)
    tok = torch.randint(0, cfg.vocab, (4, 9), generator=g)
    seen = _routes(monkeypatch)
    with spans.recording() as rec:
        Trainer(model, AdamWConfig()).value_and_grad(
            params, {"tokens": tok[:, :-1], "labels": tok[:, 1:]})
    E, k, K = cfg.moe.n_experts, cfg.moe.top_k, ctx.num_kernels
    T = tok[:, :-1].numel()
    cap = max(1, int(T * k * cf / E))
    # every kernel routes every token (psum); its own experts' pairs count
    assert len(seen) == K * cfg.n_layers
    layers = [seen[i:i + K] for i in range(0, len(seen), K)]
    routed = kept = 0
    for shards in layers:
        for s, experts in enumerate(shards):
            mine = range(s * E // K, (s + 1) * E // K)
            per = torch.bincount(experts.reshape(-1), minlength=E)
            routed += sum(int(per[e]) for e in mine)
            kept += sum(min(int(per[e]), cap) for e in mine)
    want = {"moe.routed_pairs": routed, "moe.kept_pairs": kept,
            "moe.slots": cfg.n_layers * E * cap,
            "moe.dropped_pairs": routed - kept}
    assert rec.counters == want
    assert routed == cfg.n_layers * T * k
    assert (want["moe.dropped_pairs"] > 0) == (skew > 0)


# --------------------------------------------------------------------------
# the traced runs
# --------------------------------------------------------------------------

BEFORE = {"tiny-train-ep": {"fwd_bwd_ms.train", "adamw_ms.train",
                            "exchanges_per_step.train"},
          "tiny-train-shoal": {"fwd_bwd_ms.train", "adamw_ms.train",
                               "exchanges_per_step.train",
                               "sync_ms.train"}}


@pytest.mark.parametrize("cell", [c for c in TINY if "train" in c])
def test_traced_run_prints_the_program_metrics(tiny_root, cell):
    rc, res, err = run_cell(tiny_root, cell, trace=1)
    assert rc == 0, err[-3000:]
    got = set(res["metrics"])
    # on the CPU the device's readings stay silent, the counters do not
    assert got == BEFORE[cell] | ({"expert_slot_fill.train"}
                                  if cell == "tiny-train-ep" else set())
    if cell == "tiny-train-ep":
        fill = res["metrics"]["expert_slot_fill.train"]
        assert 0 < fill["value"] <= 100 and fill["unit"] == "%"
    lines = err.splitlines()
    assert any(x.startswith("perfbench: span train.step/") for x in lines)
    program = [x for x in lines if x.startswith("perfbench: program ")]
    assert len(program) == 1 and "ring_bytes_harness" in program[0]
