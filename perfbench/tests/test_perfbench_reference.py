"""The benchmark's plain reference against the program at the CPU-size
test configurations (float32): its parameter layout, forward pass, loss
and gradients, and AdamW."""

import json
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
DATA = Path(__file__).resolve().parent / "data"
sys.path.insert(0, str(REPO))
sys.path.insert(1, str(REPO / "src"))

from perfbench import bench, weights  # noqa: E402
from perfbench.layouts import decoder as layout  # noqa: E402
from perfbench.reference import adamw  # noqa: E402
from perfbench.reference import decoder as ref  # noqa: E402

NAMES = ["tiny-dense", "tiny-moe"]


def setup(name, seed=5, ep=0):
    from repro_torch.core.state import ShoalContext
    from repro_torch.models.model import build_model
    from repro_torch.models.moe import ExpertMesh

    cfg = json.loads((DATA / "configs" / f"{name}.json").read_text())
    m = cfg["model"]
    mesh = ExpertMesh(ShoalContext(ep, device="cpu")) if ep else None
    model = build_model(bench.port_config(cfg), device="cpu", ep=mesh)
    named = weights.draw(ref.leaf_specs(m), seed, "cpu", torch.float32)
    return m, model, named


def batch(m, rows=3, seq=9, seed=1):
    g = torch.Generator().manual_seed(seed)
    t = torch.randint(0, m["vocab"], (rows, seq + 1), generator=g)
    return {"tokens": t[:, :-1], "labels": t[:, 1:]}


@pytest.mark.parametrize("name", NAMES)
def test_layout_is_the_programs_tree(name):
    from repro_torch.tree import tree_paths

    m, model, named = setup(name)
    want = tree_paths(model.init(torch.Generator().manual_seed(0)))
    got = tree_paths(layout.port_tree(m, named))
    assert [(p, t.shape, t.dtype) for p, t in got] == \
        [(p, t.shape, t.dtype) for p, t in want]
    back = layout.named(m, layout.port_tree(m, named))
    assert all(back[n] is t for n, t in named.items())


def test_same_seed_same_draws():
    m = json.loads((DATA / "configs" / "tiny-moe.json").read_text())["model"]
    a = weights.draw(ref.leaf_specs(m), 2 ** 31 + 11, "cpu", torch.bfloat16)
    b = dict(weights.iter_draw(ref.leaf_specs(m), 2 ** 31 + 11, "cpu",
                               torch.bfloat16))
    assert all(torch.equal(a[n], b[n]) for n in a)
    c = weights.draw(ref.leaf_specs(m), 2 ** 31 + 12, "cpu", torch.bfloat16)
    assert not torch.equal(a["wq"], c["wq"])


@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_the_program(name):
    m, model, named = setup(name)
    b = batch(m)
    with torch.no_grad():
        want, aux_p = model.forward_train(layout.port_tree(m, named), b,
                                          differentiable=True)
        got, aux_r = ref.forward(named, b["tokens"], m)
    assert torch.allclose(got, want, atol=1e-5, rtol=1e-5)
    assert abs(float(aux_p) - float(aux_r)) < 1e-5


@pytest.mark.parametrize("name,ep", [("tiny-dense", 0), ("tiny-moe", 0),
                                     ("tiny-moe", 2)])
def test_loss_and_grads_match_the_program(name, ep):
    from repro_torch.optim import AdamWConfig
    from repro_torch.training import Trainer

    m, model, named = setup(name, ep=ep)
    b = batch(m)
    loss_p, g_p = Trainer(model, AdamWConfig()).value_and_grad(
        layout.port_tree(m, named), b)
    loss_r, g_r = ref.loss_and_grads(named, b["tokens"], b["labels"], m)
    assert abs(float(loss_p) - loss_r) < 1e-5 * abs(loss_r)
    for n, g in layout.named(m, g_p).items():
        err = (g - g_r[n]).norm() / max(g_r[n].norm(), 1e-12)
        assert err < 1e-4, (n, float(err))


@pytest.mark.parametrize("steps", [2, 3])
def test_adamw_matches_the_programs(steps):
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.adamw import adamw_init, adamw_update

    opt = {"lr": 3e-3, "b1": 0.9, "b2": 0.95, "eps": 1e-8,
           "weight_decay": 0.1, "grad_clip": 0.5}
    g = torch.Generator().manual_seed(3)
    p0 = {"w": torch.randn(6, 5, generator=g), "b": torch.randn(5,
                                                               generator=g)}
    grads = [{n: torch.randn(t.shape, generator=g) for n, t in p0.items()}
             for _ in range(steps)]
    prog, state = {n: t.clone() for n, t in p0.items()}, None
    state = adamw_init(prog)
    for gr in grads:
        prog, state, _ = adamw_update(AdamWConfig(**opt), gr, state, prog)
    mine = {n: t.clone() for n, t in p0.items()}
    out = adamw.run(mine, lambda p, i: (0.0, dict(grads[i])), steps, opt)
    for n in p0:
        assert torch.allclose(mine[n], prog[n], atol=1e-6, rtol=1e-6)
    gn = torch.sqrt(sum(x.square().sum() for x in grads[0].values()))
    scale = min(0.5 / float(gn), 1.0)
    assert out["grad_norms"]["w"] == pytest.approx(
        float(grads[0]["w"].norm()) * scale, rel=1e-6)


def test_fp8_control_rounds_the_products():
    x = torch.linspace(-3, 3, 101)
    q = ref.fp8(x)
    # three mantissa bits: within half a step, 1/16 of |x|
    assert ((q - x).abs() <= x.abs() / 16 + 1e-6).all()
    assert (q - x).abs().max() > 0 and q.abs().max() == 3
    assert len(torch.unique(q)) < len(x)
