"""The port's ring attention (``repro_torch.models.ring_attention``) and
the ``seq_shard`` route of its model against the JAX package's, on the
CPU.

The JAX reference runs once, in one subprocess with 8 emulated CPU
devices (``python tests/test_torch_ring_attention.py OUT.npz``), on the
mesh ``("data", "model") = (2, 4)`` of ``tests/md_checks.py:526-565``;
the port runs the same programs over 4 kernels x 2 data groups
(``ExpertMesh(ShoalContext(4), data=2)``).  Inputs are numpy draws from
fixed seeds, float32 throughout:

* ``ring_attention`` at ``md_checks.py:532``'s shapes (B 2, S 64, K 2,
  G 3, dh 16) within rtol = atol = 2e-5 of the JAX ring and of the
  port's ``_attend``; ``ctx.exchanges`` of one call equal to the
  compiled JAX program's trip-weighted collective-permute count (3 a
  hop: k, v, positions; n hops);
* qwen2-smoke with ``seq_shard=True, tp=False`` (the JAX package's
  weights carried across): ``Model.loss`` within 1e-5 and every
  gradient leaf within 1e-5 of its largest |gradient|, the exchanges of
  ``value_and_grad`` (the forward's and the backward's hand-backs) equal
  to the compiled JAX ``value_and_grad``'s collective-permutes; a
  prefill through the ring on a 40-slot cache and on a 16-slot one (S
  32 > W: the last 16 keys written) -- last logits within 1e-5, every
  cache leaf equal (positions exactly) -- then one decode step (S 1: no
  ring) within 1e-5;
* the route taken exactly where the JAX package takes it
  (``_ring_ctx``, ``_apply_block``, ``gqa``): ``seq_shard`` and not
  ``tp``, more than one kernel, S > 1, GQA without a window; not with
  ``tp``, one kernel, no mesh, a decode step, recurrentgemma's local
  layers, MLA; the ``S % n`` and ``B % data`` refusals; the gradient
  through ``_permute``'s counted backward.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_reference import cp_count, run_reference  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.core import ops  # noqa: E402
from repro_torch.core.state import ShoalContext  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.attention import _attend  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.moe import ExpertMesh  # noqa: E402
from repro_torch.models.ring_attention import ring_attention  # noqa: E402
from repro_torch.tree import tree_leaves, tree_paths  # noqa: E402

DATA, K = 2, 4                      # the mesh: data groups x kernels
SHAPE = (2, 64, 2, 3, 16)           # md_checks.py:532: B, S, K, G, dh
TOL = 2e-5
MODEL_TOL = 1e-5
ARCH = "qwen2-1.5b"                 # qwen2-smoke
TOKENS = (2, 32)
CACHES = (40, 16)                   # slots: S <= W, and S > W


def _qkv(seed=0):
    rng = np.random.default_rng(seed)
    B, S, Kv, G, dh = SHAPE
    q = rng.standard_normal((B, S, Kv, G, dh)).astype(np.float32)
    k = rng.standard_normal((B, S, Kv, dh)).astype(np.float32)
    v = rng.standard_normal((B, S, Kv, dh)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    return q, k, v, pos


def _tokens(shape=TOKENS, seed=3, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


# -- the reference ---------------------------------------------------------

def _run_reference(out_path):
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.models.model import build_model as jbuild
    from repro.models.ring_attention import ring_attention as jring
    from repro.runtime.jax_compat import make_mesh

    mesh = make_mesh((DATA, K), ("data", "model"))
    out = {}
    q, k, v, pos = (jnp.asarray(a) for a in _qkv())
    fn = jax.jit(lambda *a: jring(mesh, "model", ("data",), *a))
    compiled = fn.lower(q, k, v, pos).compile()
    out["ring/out"] = np.asarray(compiled(q, k, v, pos))
    out["ring/cps"] = np.asarray(cp_count(compiled))

    cfg = dataclasses.replace(jconfigs.reduced(ARCH), tp=False,
                              seq_shard=True)
    model = jbuild(cfg, mesh=mesh, dp_axes=("data",))
    params = jbuild(cfg).init(jax.random.PRNGKey(0))
    for i, leaf in enumerate(jax.tree.leaves(jax.device_get(params))):
        out[f"params/{i}"] = np.asarray(leaf)
    toks = jnp.asarray(_tokens())
    batch = {"tokens": toks, "labels": toks}
    loss_fn = jax.jit(model.loss).lower(params, batch).compile()
    out["loss/value"] = np.asarray(loss_fn(params, batch))
    out["loss/cps"] = np.asarray(cp_count(loss_fn))
    vg_fn = jax.jit(jax.value_and_grad(model.loss)).lower(
        params, batch).compile()
    out["value_and_grad/cps"] = np.asarray(cp_count(vg_fn))
    _, grads = vg_fn(params, batch)
    for i, leaf in enumerate(jax.tree.leaves(jax.device_get(grads))):
        out[f"grads/{i}"] = np.asarray(leaf)
    for slots in CACHES:
        cache = model.make_cache(TOKENS[0], slots)
        logits, cache = jax.jit(model.prefill)(params, {"tokens": toks},
                                               cache)
        out[f"prefill/{slots}/logits"] = np.asarray(logits)
        for i, leaf in enumerate(jax.tree.leaves(jax.device_get(cache))):
            out[f"prefill/{slots}/cache/{i}"] = np.asarray(leaf)
        nxt = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        pos1 = jnp.full((TOKENS[0],), TOKENS[1], jnp.int32)
        step, _ = jax.jit(model.decode_step)(params, cache, nxt, pos1)
        out[f"prefill/{slots}/decode"] = np.asarray(step)
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(__file__,
                         tmp_path_factory.mktemp("ring") / "ref.npz")


def _mesh(kernels=K, data=DATA):
    return ExpertMesh(ShoalContext(kernels, device="cpu"), data=data)


def _cfg(**kw):
    return dataclasses.replace(configs.reduced(ARCH), **kw)


@pytest.fixture(scope="module")
def smoke(reference):
    """The port's seq_shard qwen2-smoke on the mesh, the JAX weights."""
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.tree import tree_unflatten

    cfg = _cfg(tp=False, seq_shard=True)
    like = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    n = sum(1 for key in reference if key.startswith("params/"))
    params = params_from_numpy(cfg, tree_unflatten(
        like, [reference[f"params/{i}"] for i in range(n)]), device="cpu")
    return cfg, params


def _close(got, want, tol=MODEL_TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=tol,
                               atol=tol)


# -- ring_attention --------------------------------------------------------

def test_ring_attention_matches_the_jax_ring_and_attend(reference):
    q, k, v, pos = (torch.from_numpy(a) for a in _qkv())
    mesh = _mesh()
    out = ring_attention(mesh, q, k, v, pos)
    assert out.shape == q.shape and out.dtype == q.dtype
    _close(out, reference["ring/out"], TOL)
    _close(out, _attend(q, k, v, pos, pos), TOL)
    # one exchange per tensor and hop, every hop: the compiled count
    cps = int(reference["ring/cps"])
    assert mesh.ctx.exchanges == cps == 3 * K


def test_ring_attention_masks_invalid_and_future_keys():
    """Positions -1 (unwritten slots) and keys past a query are masked
    as ``_attend`` masks them; a query whose first blocks are wholly
    masked recovers once a real key arrives (the -1e30 fill, not
    -inf)."""
    q, k, v, pos = (torch.from_numpy(a) for a in _qkv(seed=1))
    pos = pos.clone()
    pos[0, 5:9] = -1
    pos[1] = torch.flip(pos[1], (0,))     # the first shard's keys are late
    out = ring_attention(_mesh(), q, k, v, pos)
    assert torch.isfinite(out).all()
    _close(out, _attend(q, k, v, pos, pos), TOL)


@pytest.mark.parametrize("kernels, data, B, S", [(4, 2, 2, 30), (4, 2, 3, 32),
                                                (8, 1, 1, 60)])
def test_ring_attention_refuses_shapes_that_do_not_shard(kernels, data, B,
                                                         S):
    _, _, Kv, G, dh = SHAPE
    q = torch.zeros(B, S, Kv, G, dh)
    k = torch.zeros(B, S, Kv, dh)
    pos = torch.zeros(B, S, dtype=torch.int32)
    with pytest.raises(ValueError, match=f"batch {B} x sequence {S} does "
                       f"not shard over {data} data groups x {kernels}"):
        ring_attention(_mesh(kernels, data), q, k, k, pos)


def test_permute_carries_the_gradient():
    """``_permute``'s backward sends each kernel's gradient back along
    the reversed pattern (kernels that receive nothing get zeros), one
    counted exchange, noted to the lint recorder as the forward's is;
    without grad, one exchange and no autograd edge."""
    from repro_torch.analysis import trace

    ctx = ShoalContext(4, device="cpu")
    x = torch.randn(4, 3, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    w = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    ring = [(i, (i + 1) % 4) for i in range(4)]
    with trace.record() as rec:
        y = ops._permute(ctx, ring, x)
        assert ctx.exchanges == 1
        (y * w).sum().backward()
    assert ctx.exchanges == 2 and rec.unattributed == 2
    assert torch.equal(x.grad, torch.roll(w, -1, 0))
    x.grad = None
    (ops._permute(ctx, [(0, 2)], x) * w).sum().backward()
    assert ctx.exchanges == 4
    want = torch.zeros_like(w)
    want[0] = w[2]
    assert torch.equal(x.grad, want)
    with torch.no_grad():
        assert ops._permute(ctx, ring, x).grad_fn is None
    assert ops._permute(ctx, ring, x.detach()).grad_fn is None
    assert ctx.exchanges == 6


# -- the seq_shard model ---------------------------------------------------

def test_seq_shard_loss_and_gradients_match_jax(reference, smoke):
    from repro_torch.optim import AdamWConfig
    from repro_torch.training import Trainer

    cfg, params = smoke
    mesh = _mesh()
    model = build_model(cfg, device="cpu", ep=mesh)
    toks = torch.from_numpy(_tokens()).long()
    loss, grads = Trainer(model, AdamWConfig(lr=1e-3)).value_and_grad(
        params, {"tokens": toks, "labels": toks})
    _close(loss, reference["loss/value"])
    # the forward's 3 a hop (k, v, positions) and the backward's k and v
    # cotangents handed back every hop but the last, whose rotated block
    # nothing reads: the compiled JAX value_and_grad's count
    assert int(reference["loss/cps"]) == cfg.n_layers * 3 * K
    assert mesh.ctx.exchanges == int(reference["value_and_grad/cps"]) \
        == cfg.n_layers * (3 * K + 2 * (K - 1))
    paths = [p for p, _ in tree_paths(grads)]
    for i, (path, g) in enumerate(zip(paths, tree_leaves(grads))):
        want = reference[f"grads/{i}"]
        assert g.shape == want.shape, path
        np.testing.assert_allclose(
            g.double().numpy(), want, rtol=0,
            atol=MODEL_TOL * np.abs(want).max(), err_msg=path)
    # and the plain model's loss: the ring is exact
    plain = build_model(_cfg(), device="cpu")
    with torch.no_grad():
        _close(plain.loss(params, {"tokens": toks, "labels": toks}), loss)


@pytest.mark.parametrize("slots", CACHES)
def test_seq_shard_prefill_and_decode_match_jax(reference, smoke, slots):
    cfg, params = smoke
    mesh = _mesh()
    model = build_model(cfg, device="cpu", ep=mesh)
    toks = torch.from_numpy(_tokens()).long()
    cache = model.make_cache(TOKENS[0], slots)
    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": toks}, cache)
    _close(logits, reference[f"prefill/{slots}/logits"])
    assert mesh.ctx.exchanges == cfg.n_layers * 3 * K
    for i, (path, leaf) in enumerate(tree_paths(cache)):
        want = reference[f"prefill/{slots}/cache/{i}"]
        if path.endswith("pos"):
            np.testing.assert_array_equal(leaf.numpy(), want, err_msg=path)
        else:
            _close(leaf, want)
    nxt = torch.argmax(logits, -1)[:, None]
    with torch.no_grad():
        step, _ = model.decode_step(params, cache, nxt,
                                    torch.full((TOKENS[0],), TOKENS[1]))
    _close(step, reference[f"prefill/{slots}/decode"])
    assert mesh.ctx.exchanges == cfg.n_layers * 3 * K    # none in decode


# -- the route -------------------------------------------------------------

def _counted(monkeypatch):
    calls = []
    real = tattn.ring_attention

    def counted(mesh, q, *a, **kw):
        calls.append(tuple(q.shape))
        return real(mesh, q, *a, **kw)

    monkeypatch.setattr(tattn, "ring_attention", counted)
    return calls


ROUTES = {
    # name: (arch, config changes, kernels, mesh, tokens S, ring calls)
    "seq_shard": (ARCH, dict(tp=False, seq_shard=True), K, True, 8, 2),
    "tp": (ARCH, dict(tp=True, seq_shard=True), K, True, 8, 0),
    "no-seq_shard": (ARCH, dict(tp=False), K, True, 8, 0),
    "one-kernel": (ARCH, dict(tp=False, seq_shard=True), 1, True, 8, 0),
    "no-mesh": (ARCH, dict(tp=False, seq_shard=True), K, False, 8, 0),
    "decode": (ARCH, dict(tp=False, seq_shard=True), K, True, 1, 0),
    "window": ("recurrentgemma-2b", dict(tp=False, seq_shard=True), K,
               True, 8, 0),
    "mla": ("deepseek-v2-236b", dict(tp=False, seq_shard=True), K, True, 8,
            0),
}


@pytest.mark.parametrize("name", list(ROUTES))
def test_route_is_taken_where_the_jax_package_takes_it(monkeypatch, name):
    """Ring calls and exchanges of one prefill (2 rows): only ``seq_shard``
    without ``tp`` over more than one kernel, S > 1, GQA without a
    window.  Where the ring is not taken the logits equal the plain
    model's bitwise, and no exchange is made (MLA's MoE layers run on one
    device: ``tp`` off turns the island off too)."""
    arch, change, kernels, with_mesh, S, want = ROUTES[name]
    calls = _counted(monkeypatch)
    cfg = dataclasses.replace(configs.reduced(arch), **change)
    mesh = _mesh(kernels, 1) if with_mesh else None
    model = build_model(cfg, device="cpu", ep=mesh)
    params = model.init(torch.Generator().manual_seed(1))
    toks = torch.from_numpy(_tokens((2, S), vocab=cfg.vocab)).long()
    with torch.no_grad():
        got, _ = model.prefill(params, {"tokens": toks},
                               model.make_cache(2, 16))
        plain, _ = build_model(configs.reduced(arch), device="cpu").prefill(
            params, {"tokens": toks}, model.make_cache(2, 16))
    assert len(calls) == want, calls
    assert (mesh.ctx.exchanges if mesh else 0) == want * 3 * kernels
    if want:
        _close(got, plain)
    else:
        assert torch.equal(got, plain)
    # the model hands the mesh on where its own conditions hold; a
    # decode step, a local layer and MLA then take no ring
    assert (model._ring_ctx() is not None) == (
        name in ("seq_shard", "decode", "window", "mla"))
    if cfg.moe is not None:
        assert model._island is None


def test_moe_dispatch_entry_sets_seq_shard_and_keeps_its_budget():
    """The ``moe-dispatch`` lint entry sets ``seq_shard`` as the JAX
    entry does (``tp`` stays on: no ring), and its collective calls stay
    within ``comm_budgets.toml`` [moe-dispatch]."""
    from repro_torch.analysis import registry

    ctx, fn, args = registry.get("moe-dispatch").build(torch.device("cpu"))
    rep = registry.run_entry("moe-dispatch", device="cpu")
    assert rep.ok, rep.render()
    assert rep.budget["ops"]["all-to-all"] == 4
    model = fn.__self__
    assert model.cfg.seq_shard and model.cfg.tp
    assert model._ring_ctx() is None and model._island is not None


if __name__ == "__main__":
    _run_reference(sys.argv[1])
