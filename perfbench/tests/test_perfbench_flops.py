"""``perfbench/flops.py`` against hand counts at small shapes, and the
parameter counts against the program's own weights."""

import json
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
DATA = Path(__file__).resolve().parent / "data"
sys.path.insert(0, str(REPO))
sys.path.insert(1, str(REPO / "src"))

from perfbench import bench, flops  # noqa: E402


def tiny(name):
    return json.loads((DATA / "configs" / f"{name}.json").read_text())


def test_dense_counts_by_hand():
    m = tiny("tiny-dense")["model"]       # d 32, H 4, K 2, dh 8, f 64, L 2
    attn = 32 * 32 * 2 + 32 * 16 * 2
    assert flops.body_params(m) == 2 * (attn + 3 * 32 * 64) == 18432
    assert flops.head_params(m) == 32 * 128
    pairs = 2 * (4 * 5 // 2)              # 2 rows of 4 positions
    assert flops.train_step_flops(m, 2, 4) == (
        6 * (18432 + 4096) * 8 + 3 * 4 * 2 * 4 * 8 * pairs)
    assert flops.prefill_flops(m, 4) == (
        2 * 18432 * 4 + 2 * 4096 + 4 * 2 * 4 * 8 * 10)
    assert flops.decode_flops(m, [0, 3]) == (
        2 * (18432 + 4096) * 2 + 4 * 2 * 4 * 8 * (1 + 4))


def test_moe_counts_only_the_active_experts():
    m = tiny("tiny-moe")["model"]         # E 4, top 2, fe 32, L 1
    attn = 32 * 32 * 2 + 32 * 16 * 2
    assert flops.body_params(m) == attn + 32 * 4 + 2 * 3 * 32 * 32


def test_attention_pairs_are_the_causal_mask():
    S = 7
    assert flops.causal_pairs(S) == int(torch.ones(S, S).tril().sum())


@pytest.mark.parametrize("name", ["tiny-dense", "tiny-moe"])
def test_counts_match_the_programs_weights(name):
    from repro_torch.models.model import build_model
    from repro_torch.tree import tree_paths

    cfg = tiny(name)
    m = cfg["model"]
    model = build_model(bench.port_config(cfg), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    mats = {p: t.numel() for p, t in tree_paths(params)
            if p.split("/")[-1] in ("wq", "wk", "wv", "wo", "wg", "wu", "wd",
                                    "router")}
    total = sum(mats.values())
    moe = m.get("moe")
    if moe:     # the stacks hold every expert; a token runs top_k of them
        experts = sum(n for p, n in mats.items() if "/moe/w" in p)
        total += experts * moe["top_k"] // moe["n_experts"] - experts
    assert flops.body_params(m) == total
    assert flops.head_params(m) == params["embed"].numel()


def test_flash_and_ring_costs_by_hand():
    ops, rate, nbytes = flops.flash_cost(1, 4, 4, 2, 1, 8, 8, True, 2,
                                         "bfloat16")
    assert ops == 1 * 2 * 16 * 16 and rate == flops.BF16_FLOPS
    assert nbytes == 2 * (4 * 2 * 8 + 4 * 1 * 16 + 4 * 2 * 8)
    ops, rate, _ = flops.flash_cost(2, 3, 5, 2, 2, 8, 4, False, 4, "float32")
    assert ops == 2 * 2 * 2 * 3 * 5 * 12 and rate == flops.TF32_FLOPS
    assert flops.ring_bytes(100, 60) == 160


def test_shares():
    assert flops.roofline_share(989e12, flops.BF16_FLOPS, 0, 2.0) == 50.0
    assert flops.roofline_share(0, 1, 3.35e12, 4.0) == 25.0
    assert flops.share_of_peak(989e12, 10.0, "bfloat16") == pytest.approx(10)
    assert (flops.BF16_FLOPS, flops.TF32_FLOPS, flops.HBM_BPS) == (
        989e12, 495e12, 3.35e12)
