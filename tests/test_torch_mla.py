"""The port's multi-head latent attention (``models.attention``'s MLA
part) and deepseek-v2-236b (``configs.deepseek_v2_236b``) against the
JAX package's, on the CPU.

In process, JAX on one device; weights drawn by the JAX package and
carried across (``params_from_numpy`` for a model), inputs from numpy
with a fixed seed; float32, rtol = atol = 1e-5 (the same operations in
other orders) unless named:

* ``init_mla``'s tree and fan-in scales; ``_mla_qkr``;
* ``mla`` through each of its routes -- the kernel route (no cache, a
  fresh cache: the flash kernel's plain version on the CPU, at q·k head
  dim ``dh_nope + dh_rope`` and v head dim ``dh_v``), the plain route
  (``differentiable``, a cache that holds entries, a prompt longer than
  the ring) and the absorbed decode -- against the JAX ``mla``, the
  caches too, counting which calls reach ``flash_attention``; the
  materialized form (``_mla_materialized``) in the absorbed one's place
  against the JAX absorbed decode;
* ``flash_attention_ref`` at a v head dim of its own against the JAX
  ``_attend`` (bfloat16 within 3e-2: the JAX scores are rounded);
* deepseek-v2-smoke (3 layers: 1 dense, 2 MoE with 2 shared experts) and
  an MLA variant of the dense family: configs, weight trees (``qln`` and
  ``kvln`` float32 in a bfloat16 model), one prefill and two decode
  steps, ``forward_train``'s logits and aux, ``Model.loss``, gradients
  within 1e-4 of each leaf's largest |gradient|; decode token by token
  equal to the teacher-forced logits; ``ServeEngine``'s tokens equal to
  the JAX engine's, a reset lane equal to the JAX ``reset_lane``'s; the
  serving launcher and ``examples/torch_serve_lm.py``.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from serving_checks import MAX_NEW, PROMPTS  # noqa: E402
from test_torch_train import jax_arrays, port_arrays  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.serving import engine as jeng  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import attention as fa  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.convert import (cache_from_numpy,  # noqa: E402
                                        params_from_numpy)
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.serving import engine as teng  # noqa: E402
from repro_torch.training import Trainer  # noqa: E402
from repro_torch.tree import tree_paths  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "deepseek-v2-236b"
DENSE_MLA = "tinyllama-smoke-mla"
TOL = 1e-5
SLOTS = 16
D, H = 40, 4
# q·k head dim 12, v head dim 6: the routes must keep the two apart
DIMS = dict(q_lora=24, kv_lora=12, dh_nope=8, dh_rope=4, dh_v=6)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=tol,
                               atol=tol)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    """A copy of ``t`` as float32 / int32 numpy."""
    t = t.detach()
    return (t if t.dtype == torch.int32 else t.float()).numpy().copy()


@pytest.fixture
def flash_calls(monkeypatch):
    """The shapes of the attention calls that take the kernel route."""
    calls = []
    real = tattn.flash_attention

    def counted(q, k, v):
        calls.append((tuple(q.shape), tuple(k.shape), tuple(v.shape)))
        return real(q, k, v)

    monkeypatch.setattr(tattn, "flash_attention", counted)
    return calls


# -- one layer ---------------------------------------------------------------

@pytest.fixture(scope="module")
def layer():
    """JAX ``init_mla`` weights as jnp arrays, and the port's copy."""
    tree = jax.device_get(jattn.init_mla(jax.random.PRNGKey(3), D, H,
                                         jattn.MLADims(**DIMS)))
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            {k: _t(v) for k, v in tree.items()})


def test_init_mla_tree_and_scales():
    """Nine leaves, the JAX package's shapes with the layer axis in
    front, fan-in scales, the two latent norms' scales ones."""
    dims = dict(q_lora=64, kv_lora=32, dh_nope=16, dh_rope=8, dh_v=16)
    want = jax.device_get(jattn.init_mla(jax.random.PRNGKey(0), 96, 6,
                                         jattn.MLADims(**dims)))
    own = tattn.init_mla(torch.Generator().manual_seed(0), 96, 6,
                         tattn.MLADims(**dims), lead=(3,))
    assert sorted(own) == sorted(want) and len(own) == 9
    for k, v in want.items():
        got = own[k]
        assert got.shape == (3,) + v.shape and got.dtype == torch.float32, k
        if k in ("qln", "kvln"):
            assert torch.equal(got, torch.ones_like(got)) and (v == 1).all()
            continue
        scale = 1 / np.sqrt(v.shape[0])
        assert abs(got.std().item() / scale - 1) < 0.1, k
        assert abs(v.std() / scale - 1) < 0.15, k


def test_mla_qkr_matches_jax(layer):
    """Default rope base for ``q_rope`` and the one shared ``kr`` head."""
    jp, tp = layer
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, D)).astype(np.float32)
    pos = rng.integers(0, 4096, (2, 5)).astype(np.int32)
    want = jattn._mla_qkr(jp, jnp.asarray(x), jnp.asarray(pos), H,
                          jattn.MLADims(**DIMS))
    got = tattn._mla_qkr(tp, _t(x), _t(pos), H, tattn.MLADims(**DIMS))
    assert [tuple(g.shape) for g in got] == [(2, 5, H, 8), (2, 5, H, 4),
                                             (2, 5, 12), (2, 5, 4)]
    for g, w in zip(got, want):
        _close(g, w)


def _layer_cache(B, W, prefill_tokens=0, seed=0):
    """A JAX MLA cache of ``B`` lanes and ``W`` slots, fresh or holding a
    prefill of ``prefill_tokens`` random latents at positions 0..n-1."""
    cache = jattn.make_mla_cache(B, W, jattn.MLADims(**DIMS), jnp.float32)
    if prefill_tokens:
        rng = np.random.default_rng(seed)
        n = prefill_tokens
        ckv = np.array(cache["ckv"])
        kr = np.array(cache["kr"])
        pos = np.array(cache["pos"])
        ckv[:, :n] = rng.standard_normal((B, n, DIMS["kv_lora"]))
        kr[:, :n] = rng.standard_normal((B, n, DIMS["dh_rope"]))
        pos[:, :n] = np.arange(n)
        cache = {"ckv": jnp.asarray(ckv), "kr": jnp.asarray(kr),
                 "pos": jnp.asarray(pos)}
    return cache


# route -> (S, positions offset per lane, JAX cache or None, port kwargs,
# flash calls)
ROUTES = {
    "kernel-no-cache": (7, (0, 0), None, {}, 1),
    "plain-differentiable": (7, (0, 0), None, {"differentiable": True}, 0),
    "kernel-fresh-cache": (7, (0, 3), (SLOTS, 0), {"fresh": True}, 1),
    "plain-stale-cache": (4, (6, 6), (SLOTS, 6), {}, 0),
    "plain-longer-than-ring": (SLOTS + 5, (0, 0), (SLOTS, 0),
                               {"fresh": True}, 0),
    "absorbed-decode": (1, (6, 9), (SLOTS, 6), {}, 0),
    "materialized-decode": (1, (6, 9), (SLOTS, 6), {}, 0),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_mla_routes_match_jax(layer, flash_calls, monkeypatch, route):
    """Each route of the port's ``mla`` against the JAX ``mla`` (which
    materializes every prompt pass and absorbs every one-token step),
    the written caches too; only the kernel routes reach
    ``flash_attention``, at q·k head dim 12 and v head dim 6."""
    jp, tp = layer
    S, offsets, cache_spec, kwargs, n_flash = ROUTES[route]
    B = 2
    rng = np.random.default_rng(len(route))
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    pos = (np.arange(S)[None] + np.array(offsets)[:, None]).astype(np.int32)
    jcache = None if cache_spec is None else _layer_cache(B, *cache_spec)
    if route == "materialized-decode":     # chip_smoke.py's identity check
        monkeypatch.setattr(tattn, "_mla_absorbed", tattn._mla_materialized)
    want, jnew = jattn.mla(jp, jnp.asarray(x), jnp.asarray(pos), H=H,
                           dims=jattn.MLADims(**DIMS), cache=jcache)
    tcache = None if jcache is None else {
        k: _t(jax.device_get(v)) for k, v in jcache.items()}
    if kwargs.get("differentiable"):
        tp = {k: v.clone().requires_grad_() for k, v in tp.items()}
    got, tnew = tattn.mla(tp, _t(x), _t(pos).long(), H=H,
                          dims=tattn.MLADims(**DIMS), cache=tcache, **kwargs)
    _close(got.detach(), want)
    if jcache is not None:
        assert tnew is tcache          # written in place
        for k in ("ckv", "kr", "pos"):
            _close(_np(tnew[k]), jnew[k])
    assert len(flash_calls) == n_flash
    if n_flash:
        assert flash_calls[0] == ((B, S, H, 12), (B, S, H, 12),
                                  (B, S, H, 6))
    if kwargs.get("differentiable"):
        got.sum().backward()
        assert all(p.grad is not None for p in tp.values())


@pytest.mark.parametrize("dtype,tol", [(torch.float32, TOL),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("B,S,H_,K,dqk,dv", [
    (2, 9, 4, 4, 12, 6), (1, 33, 6, 2, 24, 16), (1, 17, 2, 2, 192, 128)])
def test_flash_ref_with_its_own_v_head_dim_matches_jax_attend(
        dtype, tol, B, S, H_, K, dqk, dv):
    """``(B, S, H, dqk)`` queries over ``(B, S, K, dv)`` values give
    ``(B, S, H, dv)``, scaled by ``1/sqrt(dqk)``."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    rng = np.random.default_rng(S + dqk)
    q = rng.standard_normal((B, S, H_, dqk)).astype(np.float32)
    k = rng.standard_normal((B, S, K, dqk)).astype(np.float32)
    v = rng.standard_normal((B, S, K, dv)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    want = jattn._attend(jnp.asarray(q, jdt).reshape(B, S, K, H_ // K, dqk),
                         jnp.asarray(k, jdt), jnp.asarray(v, jdt),
                         jnp.asarray(pos), jnp.asarray(pos))
    got = fa.flash_attention(*(_t(a).to(dtype) for a in (q, k, v)))
    assert got.shape == (B, S, H_, dv) and got.dtype == dtype
    np.testing.assert_allclose(
        got.float().numpy(),
        np.asarray(want, np.float32).reshape(B, S, H_, dv), rtol=tol,
        atol=tol)


# -- deepseek-v2-smoke and a dense-family MLA model --------------------------

def _cfgs(name):
    if name == DENSE_MLA:
        j = dataclasses.replace(
            jconfigs.reduced("tinyllama-1.1b"), name=name,
            mla=jattn.MLADims(q_lora=32, kv_lora=16, dh_nope=16, dh_rope=8,
                              dh_v=16))
        t = dataclasses.replace(
            configs.reduced("tinyllama-1.1b"), name=name,
            mla=tattn.MLADims(q_lora=32, kv_lora=16, dh_nope=16, dh_rope=8,
                              dh_v=16))
        return j, t
    return jconfigs.reduced(ARCH), configs.reduced(ARCH)


_PAIRS = {}


def pair(name):
    """(jax model, jax params, port model, port params) of ``name``."""
    if name not in _PAIRS:
        jcfg, tcfg = _cfgs(name)
        jm = jbuild(jcfg)
        jparams = jm.init(jax.random.PRNGKey(0))
        tm = build_model(tcfg, device="cpu")
        _PAIRS[name] = (jm, jparams, tm, params_from_numpy(
            tcfg, jax.device_get(jparams), device="cpu"))
    return _PAIRS[name]


NAMES = ["deepseek-v2-smoke", DENSE_MLA]


def test_deepseek_v2_configs_match_the_jax_package():
    for name in ("full", "reduced"):
        got = getattr(configs, name)(ARCH)
        want = getattr(jconfigs, name)(ARCH)
        for f in ("name", "family", "n_layers", "d_model", "n_heads",
                  "n_kv_heads", "d_ff", "vocab", "dh", "qkv_bias",
                  "tie_embeddings", "rope_base", "norm", "mlp", "frontend",
                  "first_k_dense", "aux_loss_weight"):
            assert getattr(got, f) == getattr(want, f), (name, f)
        assert dataclasses.asdict(got.mla) == dataclasses.asdict(want.mla)
        assert dataclasses.asdict(got.moe) == dataclasses.asdict(want.moe)
        assert str(got.dtype).split(".")[-1] == jnp.dtype(want.dtype).name
        assert got.segments() == want.segments()
    full = configs.full(ARCH)
    assert (full.n_layers, full.d_model, full.n_heads, full.d_ff, full.vocab,
            full.first_k_dense, full.moe.n_experts, full.moe.top_k,
            full.moe.d_ff_expert, full.moe.n_shared, full.dtype) == (
        60, 5120, 128, 12288, 102400, 1, 160, 6, 1536, 2, torch.bfloat16)
    assert dataclasses.astuple(full.mla) == (1536, 512, 128, 64, 128)
    assert configs.reduced(ARCH).name == "deepseek-v2-smoke"


@pytest.mark.parametrize("name", NAMES)
def test_weight_tree_carries_across(name):
    """The port's init has the JAX tree (nine MLA leaves a block) and
    ``params_from_numpy`` carries every leaf; in a bfloat16 model the
    latent norms' scales stay float32, as the block norms' do."""
    _, jparams, tm, tparams = pair(name)
    own = tm.init(torch.Generator().manual_seed(0))
    shapes = {p: tuple(t.shape) for p, t in tree_paths(own)}
    want = jax_arrays(jparams)
    got = port_arrays(tparams)
    assert list(shapes) == list(want) == list(got)
    for p, a in want.items():
        assert shapes[p] == a.shape, p
        np.testing.assert_array_equal(got[p], a, err_msg=p)
    assert sum(p.endswith("attn/kvln") for p in shapes) == len(tm.segs)
    bf16 = dataclasses.replace(tm.cfg, dtype=torch.bfloat16)
    carried = params_from_numpy(bf16, jax.device_get(jparams), device="cpu")
    for p, t in tree_paths(carried):
        last = p.split("/")[-1]
        f32 = last in ("qln", "kvln") or "ln1" in p or "ln2" in p \
            or "final_norm" in p
        assert t.dtype == (torch.float32 if f32 else torch.bfloat16), p
    for p, t in tree_paths(build_model(bf16, device="cpu").init(
            torch.Generator().manual_seed(0))):
        if p.split("/")[-1] in ("qln", "kvln"):
            assert t.dtype == torch.float32, p


@pytest.mark.parametrize("name", NAMES)
def test_logits_aux_and_loss_match_jax(name, flash_calls):
    jm, jparams, tm, tparams = pair(name)
    toks = np.random.default_rng(5).integers(0, 512, (2, 12)).astype(
        np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    jl, ja = jax.jit(jm.forward_train)(jparams, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        tl, ta = tm.forward_train(tparams, {"tokens": _t(toks).long()})
    _close(tl, jl)
    _close(ta, ja)
    assert len(flash_calls) == tm.cfg.n_layers
    assert (float(ta) > 0) == (name != DENSE_MLA)
    jloss = jax.jit(jm.loss)(jparams, {k: jnp.asarray(v)
                                       for k, v in batch.items()})
    with torch.no_grad():
        tloss = tm.loss(tparams, {k: _t(v).long() for k, v in batch.items()})
    _close(tloss, jloss)
    assert len(flash_calls) == tm.cfg.n_layers      # loss: the plain route


@pytest.mark.parametrize("name", NAMES)
def test_gradients_match_jax(name):
    jm, jparams, tm, tparams = pair(name)
    toks = np.random.default_rng(6).integers(0, 512, (2, 12)).astype(
        np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    jloss, jgrads = jax.value_and_grad(jm.loss)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = Trainer(tm, AdamWConfig(lr=1e-3)).value_and_grad(
        tparams, {k: _t(v).long() for k, v in batch.items()})
    _close(loss, jloss)
    got, want = port_arrays(grads), jax_arrays(jgrads)
    assert list(got) == list(want)
    for path in want:
        scale = np.abs(want[path]).max()
        np.testing.assert_allclose(got[path], want[path], rtol=0,
                                   atol=1e-4 * scale, err_msg=path)
    latent = [p for p in want if p.endswith(("attn/wuk", "attn/kvln"))]
    assert latent and all(np.abs(want[p]).max() > 0 for p in latent)


@pytest.mark.parametrize("name", NAMES)
def test_prefill_and_two_decode_steps_match_jax(name, flash_calls):
    """Prefill on a fresh cache (the kernel route), then two absorbed
    decode steps at mixed positions; logits and caches."""
    jm, jparams, tm, tparams = pair(name)
    toks = np.random.default_rng(7).integers(0, 512, (2, 9)).astype(np.int32)
    jcache = jm.make_cache(2, SLOTS)
    tcache = cache_from_numpy(tm.cfg, jax.device_get(jcache), device="cpu")
    assert sorted(tcache[0]["b0_dense"]) == ["ckv", "kr", "pos"]
    jl, jc = jax.jit(jm.prefill)(jparams, {"tokens": jnp.asarray(toks)},
                                 jcache)
    tl, tc = tm.prefill(tparams, {"tokens": _t(toks).long()}, tcache)
    _close(tl, jl)
    assert len(flash_calls) == tm.cfg.n_layers
    step = np.array([[3], [400]], np.int32)
    pos = np.array([9, 12], np.int32)
    jdecode = jax.jit(jm.decode_step)
    for _ in range(2):
        jl, jc = jdecode(jparams, jc, jnp.asarray(step), jnp.asarray(pos))
        tl, tc = tm.decode_step(tparams, tc, _t(step).long(), _t(pos).long())
        _close(tl, jl)
        step = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]
        pos = pos + 1
    for got, want in zip(jax.tree.leaves([{k: _np(v) for k, v in b.items()}
                                          for seg in tc
                                          for b in seg.values()]),
                         jax.tree.leaves([dict(b) for seg in jc
                                          for b in seg.values()])):
        _close(got, want)
    assert len(flash_calls) == tm.cfg.n_layers


def test_decode_token_by_token_equals_teacher_forced_logits():
    """The JAX package's ``test_prefill_decode_consistency`` rule on
    deepseek-v2-smoke: a prefill of 4 tokens (the kernel route) and 8
    absorbed decode steps give the forward pass's logits (JAX's
    tolerance, 2e-3); the JAX model's decode gives the port's (1e-5).
    At capacity factor 16 no expert drops a pair: at the default 1.25 a
    12-token forward pass drops pairs that one-token steps keep."""
    _, jparams, tm, tparams = pair("deepseek-v2-smoke")
    jcfg, tcfg = _cfgs("deepseek-v2-smoke")
    jm = jbuild(dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, capacity_factor=16.0)))
    tm = build_model(dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, capacity_factor=16.0)), device="cpu")
    S, p = 12, 4
    toks = np.random.default_rng(3).integers(0, 512, (1, S)).astype(np.int32)
    with torch.no_grad():
        fwd, _ = tm.forward_train(tparams, {"tokens": _t(toks).long()})
    cache = tm.make_cache(1, 32)
    jcache = jm.make_cache(1, 32)
    lg, cache = tm.prefill(tparams, {"tokens": _t(toks[:, :p]).long()}, cache)
    _, jcache = jax.jit(jm.prefill)(jparams, {"tokens": jnp.asarray(
        toks[:, :p])}, jcache)
    _close(lg, fwd[:, p - 1], 2e-3)
    jdecode = jax.jit(jm.decode_step)
    for t in range(p, S):
        pos = np.full((1,), t, np.int32)
        lg, cache = tm.decode_step(tparams, cache, _t(toks[:, t:t + 1]).long(),
                                   _t(pos).long())
        jl, jcache = jdecode(jparams, jcache, jnp.asarray(toks[:, t:t + 1]),
                             jnp.asarray(pos))
        _close(lg, fwd[:, t], 2e-3)
        _close(lg, jl)


# -- the engine --------------------------------------------------------------

def _requests(cls):
    return [cls(i, np.asarray(p, np.int32), m)
            for i, (p, m) in enumerate(zip(PROMPTS, MAX_NEW))]


def test_engine_serves_the_jax_engines_tokens():
    """deepseek-v2-smoke on 2 lanes of 16 slots: lane reuse, more
    requests than lanes, prompt passes on the kernel route, absorbed
    decode; the JAX engine's tokens exactly."""
    jm, jparams, tm, tparams = pair("deepseek-v2-smoke")
    want = jeng.ServeEngine(jm, jparams, lanes=2, slots=SLOTS).run(
        _requests(jeng.Request))
    done = teng.ServeEngine(tm, tparams, lanes=2, slots=SLOTS).run(
        _requests(teng.Request))
    assert [(r.rid, r.out) for r in done] == [(r.rid, r.out) for r in want]
    assert [len(r.out) for r in sorted(done, key=lambda r: r.rid)] == MAX_NEW


def test_reset_lane_matches_jax():
    """A served lane reset: ``ckv`` and ``kr`` zero, ``pos`` -1, the other
    lane untouched -- the JAX ``reset_lane`` of the same cache."""
    _, _, tm, tparams = pair("deepseek-v2-smoke")
    eng = teng.ServeEngine(tm, tparams, lanes=2, slots=SLOTS)
    for req in _requests(teng.Request)[:2]:
        eng.submit(req)
    eng.step()
    before = [{k: {n: _np(t) for n, t in b.items()} for k, b in seg.items()}
              for seg in eng.cache]
    want = jax.device_get(jeng.reset_lane(jax.tree.map(jnp.asarray, before),
                                          1))
    teng.reset_lane(eng.cache, 1)
    for seg, wseg in zip(eng.cache, want):
        for key, blk in seg.items():
            assert sorted(blk) == ["ckv", "kr", "pos"]
            for n, t in blk.items():
                np.testing.assert_array_equal(_np(t), wseg[key][n])
                assert (_np(t)[:, 1] == (-1 if n == "pos" else 0)).all()
    assert (before[0]["b0_dense"]["pos"][:, 1] >= 0).any()


def test_launch_serve_on_the_cpu(capsys):
    from repro_torch.launch import serve

    assert serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--requests", "2", "--max-new", "3",
                       "--slots", "16"]) == 0
    out = capsys.readouterr().out
    assert "[serve] deepseek-v2-smoke: 2 requests, 6 tokens" in out


def test_serve_lm_example_serves_deepseek_v2_on_the_cpu():
    """``examples/torch_serve_lm.py --arch deepseek-v2-236b --device cpu``
    with JAX and the JAX package blocked."""
    code = ("import runpy, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "sys.argv = ['torch_serve_lm.py', '--device', 'cpu', '--arch', "
            f"{ARCH!r}]\n"
            f"runpy.run_path({os.path.join(REPO, 'examples', 'torch_serve_lm.py')!r}, "
            "run_name='__main__')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("req ") == 6
    assert "[serve] deepseek-v2-smoke: 6 requests, 72 tokens" in proc.stdout
