"""The port's cross-attention (``models.attention``'s cross part), the vlm
family and llama-3.2-vision-90b (``configs.llama_3_2_vision_90b``)
against the JAX package's, on the CPU.

In process, JAX on one device; weights drawn by the JAX package, the
cross layers' gates opened in the numpy tree (``init_cross`` draws
``gate = 0``, which would hide the layer) and carried across
(``params_from_numpy`` for a model), inputs from numpy with a fixed
seed; float32, rtol = atol = 1e-5 (the same operations in other orders)
unless named:

* ``init_cross``'s tree, its fan-in scales, and its float32 leaves
  (``gate``, ``qln``, ``kln``) in a bfloat16 model;
* ``cross_attention`` through both routes -- the kernel route (a prompt
  pass: the flash kernel's plain version with ``causal=False`` on the
  CPU) and ``_attend`` (a decode step, a differentiable pass) -- against
  the JAX ``cross_attention``, counting the calls that reach
  ``flash_attention``;
* ``flash_attention_ref(causal=False)`` against the JAX
  ``attention_ref(causal=False)`` at S != T, the Pallas kernel
  ``flash_attention_pallas(causal=False, interpret=True)`` at a block
  multiple (its padded wrapper branch is causal: ROADMAP §3, "Flash,
  padded non-causal"), and the JAX ``_attend(causal=False)`` at S != T
  in the GQA layout (the reference's tolerances, float32 2e-3 against
  the Pallas kernel, bfloat16 3e-2: it rounds p per block);
* llama-vision-smoke (5 layers: 4 dense and 1 cross, 16 image tokens):
  the config, the weight tree, one prefill and two
  ``decode_step(image_feats=)`` steps with the caches, decode token by
  token equal to the teacher-forced logits, ``forward_train``'s logits,
  ``Model.loss`` and gradients within 1e-4 of each leaf's largest
  |gradient|, one shoal step at K 2 equal to the xla backend, and the
  port's ``launch/train`` on the reduced config;
* the ``ValueError`` of a cross block that gets no ``image_feats``.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_train import jax_arrays, port_arrays  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.kernels.attention.flash import flash_attention_pallas  # noqa: E402
from repro.kernels.attention.ref import attention_ref  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import attention as fa  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.convert import (cache_from_numpy,  # noqa: E402
                                        params_from_numpy)
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.training import Trainer, TrainerConfig  # noqa: E402
from repro_torch.tree import tree_paths  # noqa: E402

ARCH = "llama-3.2-vision-90b"
TOL = 1e-5
SLOTS = 16
D, H, K, DH, N = 40, 4, 2, 10, 9
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-3),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


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


def _open_gates(tree, seed=1):
    """``tree`` (numpy, as ``jax.device_get`` gives it) with every cross
    layer's gate drawn uniform in [0.5, 1]: ``init_cross`` draws 0, so
    ``tanh(gate)`` would zero the layer's output."""
    rng = np.random.default_rng(seed)

    def walk(node):
        if not isinstance(node, dict):
            return node
        out = {k: walk(v) for k, v in node.items()}
        if "gate" in out:
            out["gate"] = rng.uniform(0.5, 1.0, np.shape(out["gate"])).astype(
                np.float32)
        return out

    if isinstance(tree, dict) and "segments" in tree:
        return dict(tree, segments=[walk(s) for s in tree["segments"]])
    return walk(tree)


@pytest.fixture
def flash_calls(monkeypatch):
    """The shapes and causality of the attention calls that take the
    kernel route."""
    calls = []
    real = tattn.flash_attention

    def counted(q, k, v, causal=True):
        calls.append((tuple(q.shape), tuple(k.shape), tuple(v.shape),
                      causal))
        return real(q, k, v, causal=causal)

    monkeypatch.setattr(tattn, "flash_attention", counted)
    return calls


# -- one layer ---------------------------------------------------------------

def test_init_cross_tree_and_scales():
    """Seven leaves, the JAX package's shapes with the layer axis in
    front, fan-in scales, the norms' scales ones and the gate zero."""
    want = jax.device_get(jattn.init_cross(jax.random.PRNGKey(0), 96, 6, 2,
                                           16))
    own = tattn.init_cross(torch.Generator().manual_seed(0), 96, 6, 2, 16,
                           lead=(3,))
    assert sorted(own) == sorted(want) == ["gate", "kln", "qln", "wk", "wo",
                                           "wq", "wv"]
    for k, v in want.items():
        got = own[k]
        assert got.shape == (3,) + v.shape and got.dtype == torch.float32, k
        if k == "gate":
            assert not got.any() and (v == 0).all()
            continue
        if k in ("qln", "kln"):
            assert torch.equal(got, torch.ones_like(got)) and (v == 1).all()
            continue
        scale = 1 / np.sqrt(v.shape[0])
        assert abs(got.std().item() / scale - 1) < 0.1, k
        assert abs(v.std() / scale - 1) < 0.15, k


@pytest.fixture(scope="module")
def layer():
    """JAX ``init_cross`` weights with the gate opened, as jnp arrays,
    and the port's copy."""
    tree = _open_gates(jax.device_get(jattn.init_cross(
        jax.random.PRNGKey(3), D, H, K, DH)))
    assert 0.5 <= float(tree["gate"]) <= 1.0
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            {k: _t(v) for k, v in tree.items()})


# route -> (S, port kwargs, flash calls)
ROUTES = {
    "kernel-prompt": (7, {}, 1),
    "plain-decode": (1, {}, 0),
    "plain-differentiable": (7, {"differentiable": True}, 0),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_cross_attention_routes_match_jax(layer, flash_calls, route):
    """Each route of the port's ``cross_attention`` against the JAX
    ``cross_attention`` (which attends through ``_attend`` on every
    pass); only the prompt pass reaches ``flash_attention``, non-causal,
    S text tokens over the N image tokens."""
    jp, tp = layer
    S, kwargs, n_flash = ROUTES[route]
    B = 2
    rng = np.random.default_rng(len(route))
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    feats = rng.standard_normal((B, N, D)).astype(np.float32)
    want = jattn.cross_attention(jp, jnp.asarray(x), jnp.asarray(feats),
                                 H=H, K=K, dh=DH)
    if kwargs.get("differentiable"):
        tp = {k: v.clone().requires_grad_() for k, v in tp.items()}
    got = tattn.cross_attention(tp, _t(x), _t(feats), H=H, K=K, dh=DH,
                                **kwargs)
    assert got.shape == (B, S, D)
    _close(got.detach(), want)
    assert np.abs(np.asarray(want)).max() > 1e-2       # the gate is open
    assert len(flash_calls) == n_flash
    if n_flash:
        assert flash_calls[0] == ((B, S, H, DH), (B, N, K, DH),
                                  (B, N, K, DH), False)
    if kwargs.get("differentiable"):
        got.sum().backward()
        assert all(p.grad is not None for p in tp.values())
        assert tp["gate"].grad.abs().item() > 0


def test_cross_attention_casts_features_before_the_projections(layer):
    """Float32 image features into a bfloat16 text stream: cast to
    bfloat16 first, as the JAX package does (the products are then
    bfloat16 on both sides); 3e-2."""
    jp, tp = layer
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, 5, D)).astype(np.float32)
    feats = rng.standard_normal((1, N, D)).astype(np.float32)
    want = jattn.cross_attention(jp, jnp.asarray(x, jnp.bfloat16),
                                 jnp.asarray(feats), H=H, K=K, dh=DH)
    got = tattn.cross_attention(tp, _t(x).bfloat16(), _t(feats), H=H, K=K,
                                dh=DH)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    _close(got.float(), np.asarray(want, np.float32), 3e-2)


# -- the non-causal flash function --------------------------------------------

@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("bh,s,t,dh", [(2, 9, 16, 8), (3, 16, 5, 32),
                                       (1, 4, 1, 16)])
def test_noncausal_flash_ref_matches_jax_attention_ref(dtype, bh, s, t, dh):
    """S queries over T != S keys, every key valid."""
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(s * t)
    q = rng.standard_normal((bh, s, dh)).astype(np.float32)
    k, v = (rng.standard_normal((bh, t, dh)).astype(np.float32)
            for _ in range(2))
    want = attention_ref(jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                         jnp.asarray(v, jdt), causal=False)
    got = fa.flash_attention(*(_t(a).to(tdt)[:, :, None] for a in (q, k, v)),
                             causal=False)
    assert got.shape == (bh, s, 1, dh) and got.dtype == tdt
    _close(got[:, :, 0].float(), np.asarray(want, np.float32),
           TOL if dtype == "float32" else tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("bh,s,dh,blk", [(2, 256, 64, 128),
                                         (4, 128, 128, 64)])
def test_noncausal_flash_ref_matches_pallas_interpret(dtype, bh, s, dh, blk):
    """The TPU kernel's ``causal=False`` branch, called directly at a
    block multiple (the JAX wrapper's padded branch is causal)."""
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(s + dh)
    q, k, v = (rng.standard_normal((bh, s, dh)).astype(np.float32)
               for _ in range(3))
    want = flash_attention_pallas(jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                                  jnp.asarray(v, jdt), causal=False,
                                  block_q=blk, block_k=blk, interpret=True)
    got = fa.flash_attention(*(_t(a).to(tdt)[:, :, None] for a in (q, k, v)),
                             causal=False)
    np.testing.assert_allclose(got[:, :, 0].float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)
    causal = fa.flash_attention(*(_t(a).to(tdt)[:, :, None]
                                  for a in (q, k, v)))
    assert not torch.allclose(causal, got)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,S,H_,K_,T,dh", [(2, 7, 4, 2, 16, 8),
                                            (1, 1, 6, 2, 9, 16),
                                            (1, 33, 4, 4, 3, 32)])
def test_noncausal_flash_ref_matches_jax_attend(dtype, B, S, H_, K_, T, dh):
    """Query head h reads kv head h // (H // K); ``_attend(causal=False)``
    with every position 0, as the JAX ``cross_attention`` calls it."""
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(S + T)
    q = rng.standard_normal((B, S, H_, dh)).astype(np.float32)
    k, v = (rng.standard_normal((B, T, K_, dh)).astype(np.float32)
            for _ in range(2))
    want = jattn._attend(jnp.asarray(q, jdt).reshape(B, S, K_, H_ // K_, dh),
                         jnp.asarray(k, jdt), jnp.asarray(v, jdt),
                         jnp.zeros((B, S), jnp.int32),
                         jnp.zeros((B, T), jnp.int32), causal=False)
    got = fa.flash_attention(*(_t(a).to(tdt) for a in (q, k, v)),
                             causal=False)
    np.testing.assert_allclose(
        got.float().numpy(),
        np.asarray(want, np.float32).reshape(B, S, H_, dh),
        rtol=TOL if dtype == "float32" else tol,
        atol=TOL if dtype == "float32" else tol)
    plain = tattn._attend(*(_t(a).to(tdt) for a in (
        q.reshape(B, S, K_, H_ // K_, dh), k, v)),
        torch.zeros(B, S, dtype=torch.int32),
        torch.zeros(B, T, dtype=torch.int32), causal=False)
    np.testing.assert_allclose(
        plain.float().numpy(),
        np.asarray(want, np.float32).reshape(B, S, K_, H_ // K_, dh),
        rtol=TOL if dtype == "float32" else tol,
        atol=TOL if dtype == "float32" else tol)


def test_causal_flash_ref_refuses_another_key_length():
    q = torch.zeros(1, 4, 2, 8)
    kv = torch.zeros(1, 6, 2, 8)
    with pytest.raises(ValueError, match="causal attention"):
        fa.flash_attention(q, kv, kv)
    assert fa.flash_attention(q, kv, kv, causal=False).shape == (1, 4, 2, 8)


# -- llama-vision-smoke -------------------------------------------------------

_PAIR = {}


def pair():
    """(jax model, jax params, port model, port params) of
    llama-vision-smoke, the cross layer's gate opened in both."""
    if not _PAIR:
        jm = jbuild(jconfigs.reduced(ARCH))
        tree = _open_gates(jax.device_get(jm.init(jax.random.PRNGKey(0))))
        tm = build_model(configs.reduced(ARCH), device="cpu")
        _PAIR["v"] = (jm, jax.tree.map(jnp.asarray, tree), tm,
                      params_from_numpy(tm.cfg, tree, device="cpu"))
    return _PAIR["v"]


def _feats(B, seed, cfg=None):
    cfg = cfg or configs.reduced(ARCH)
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)


def test_vlm_configs_match_the_jax_package():
    for name in ("full", "reduced"):
        got = getattr(configs, name)(ARCH)
        want = getattr(jconfigs, name)(ARCH)
        for f in ("name", "family", "n_layers", "d_model", "n_heads",
                  "n_kv_heads", "d_ff", "vocab", "dh", "qkv_bias",
                  "tie_embeddings", "rope_base", "norm", "mlp", "frontend",
                  "cross_every", "n_image_tokens", "aux_loss_weight"):
            assert getattr(got, f) == getattr(want, f), (name, f)
        assert str(got.dtype).split(".")[-1] == jnp.dtype(want.dtype).name
        assert got.segments() == want.segments()
    full = configs.full(ARCH)
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.dh, full.d_ff, full.vocab, full.cross_every,
            full.n_image_tokens, full.rope_base, full.dtype) == (
        100, 8192, 64, 8, 128, 28672, 128256, 5, 1600, 5e5, torch.bfloat16)
    assert full.segments() == [(("dense",) * 4 + ("cross",), 20)]
    assert configs.get("llama-3.2-vision-90b") is configs.get(
        "llama_3_2_vision_90b")
    with pytest.raises(ValueError, match="cross_every"):
        dataclasses.replace(full, n_layers=12).segments()


def test_weight_tree_carries_across():
    """The port's init has the JAX tree (seven cross-attention leaves in
    the cross block) and ``params_from_numpy`` carries every leaf; in a
    bfloat16 model the cross layer's ``gate``, ``qln`` and ``kln`` stay
    float32, as the block norms do."""
    jm, jparams, tm, tparams = pair()
    own = tm.init(torch.Generator().manual_seed(0))
    shapes = {p: tuple(t.shape) for p, t in tree_paths(own)}
    want = jax_arrays(jparams)
    got = port_arrays(tparams)
    assert list(shapes) == list(want) == list(got)
    for p, a in want.items():
        assert shapes[p] == a.shape, p
        np.testing.assert_array_equal(got[p], a, err_msg=p)
    cross = [p for p in shapes if "/b4_cross/xattn/" in p]
    assert sorted(p.split("/")[-1] for p in cross) == [
        "gate", "kln", "qln", "wk", "wo", "wq", "wv"]
    assert shapes["segments/0/b4_cross/xattn/gate"] == (1,)
    assert (want["segments/0/b4_cross/xattn/gate"] >= 0.5).all()
    bf16 = dataclasses.replace(tm.cfg, dtype=torch.bfloat16)
    for tree in (params_from_numpy(bf16, jax.device_get(jparams),
                                   device="cpu"),
                 build_model(bf16, device="cpu").init(
                     torch.Generator().manual_seed(0))):
        for p, t in tree_paths(tree):
            last = p.split("/")[-1]
            f32 = last in ("qln", "kln", "gate") or "ln1" in p \
                or "ln2" in p or "final_norm" in p
            assert t.dtype == (torch.float32 if f32 else torch.bfloat16), p


def test_logits_and_loss_match_jax(flash_calls):
    """``forward_train`` (every prompt pass on the kernel route: 4 causal
    self-attention layers, 1 non-causal cross layer) and ``Model.loss``
    (the plain route); the image features move the logits."""
    jm, jparams, tm, tparams = pair()
    toks = np.random.default_rng(5).integers(0, 512, (2, 12)).astype(
        np.int32)
    feats = _feats(2, 5)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1),
             "image_feats": feats}
    jl, ja = jax.jit(jm.forward_train)(jparams, {
        "tokens": jnp.asarray(toks), "image_feats": jnp.asarray(feats)})
    with torch.no_grad():
        tl, ta = tm.forward_train(tparams, {"tokens": _t(toks).long(),
                                            "image_feats": _t(feats)})
    _close(tl, jl)
    assert float(ta) == 0.0 and float(ja) == 0.0
    assert [c[3] for c in flash_calls] == [True] * 4 + [False]
    assert flash_calls[4][1] == (2, 16, 2, 16)         # N image tokens
    with torch.no_grad():
        other, _ = tm.forward_train(tparams, {"tokens": _t(toks).long(),
                                              "image_feats": _t(_feats(2,
                                                                       6))})
    assert (other - tl).abs().max().item() > 1e-3
    jloss = jax.jit(jm.loss)(jparams, {k: jnp.asarray(v)
                                       for k, v in batch.items()})
    tbatch = {"tokens": _t(toks).long(), "labels": _t(batch["labels"]).long(),
              "image_feats": _t(feats)}
    with torch.no_grad():
        tloss = tm.loss(tparams, tbatch)
    _close(tloss, jloss)
    assert len(flash_calls) == 10       # two forwards; loss: plain route


def test_gradients_match_jax():
    jm, jparams, tm, tparams = pair()
    toks = np.random.default_rng(6).integers(0, 512, (2, 12)).astype(
        np.int32)
    feats = _feats(2, 7)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1),
             "image_feats": feats}
    jloss, jgrads = jax.value_and_grad(jm.loss)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = Trainer(tm, AdamWConfig(lr=1e-3)).value_and_grad(
        tparams, {"tokens": _t(toks).long(),
                  "labels": _t(batch["labels"]).long(),
                  "image_feats": _t(feats)})
    _close(loss, jloss)
    got, want = port_arrays(grads), jax_arrays(jgrads)
    assert list(got) == list(want)
    for path in want:
        scale = np.abs(want[path]).max()
        np.testing.assert_allclose(got[path], want[path], rtol=0,
                                   atol=1e-4 * scale, err_msg=path)
    cross = [p for p in want if "/xattn/" in p]
    assert len(cross) == 7 and all(np.abs(want[p]).max() > 0 for p in cross)


def test_prefill_and_two_decode_steps_match_jax(flash_calls):
    """Prefill on a fresh cache (every prompt pass on the kernel route),
    then two decode steps at mixed positions re-attending the image
    features (the plain route); logits and caches (the cross block has
    none)."""
    jm, jparams, tm, tparams = pair()
    toks = np.random.default_rng(7).integers(0, 512, (2, 9)).astype(np.int32)
    feats = _feats(2, 8)
    jcache = jm.make_cache(2, SLOTS)
    tcache = cache_from_numpy(tm.cfg, jax.device_get(jcache), device="cpu")
    assert tcache[0]["b4_cross"] == {}
    assert sorted(tcache[0]["b0_dense"]) == ["k", "pos", "v"]
    jl, jc = jax.jit(jm.prefill)(jparams, {"tokens": jnp.asarray(toks),
                                           "image_feats": jnp.asarray(feats)},
                                 jcache)
    tl, tc = tm.prefill(tparams, {"tokens": _t(toks).long(),
                                  "image_feats": _t(feats)}, tcache)
    _close(tl, jl)
    assert [c[3] for c in flash_calls] == [True] * 4 + [False]
    step = np.array([[3], [400]], np.int32)
    pos = np.array([9, 12], np.int32)
    jdecode = jax.jit(jm.decode_step)
    for _ in range(2):
        jl, jc = jdecode(jparams, jc, jnp.asarray(step), jnp.asarray(pos),
                         jnp.asarray(feats))
        tl, tc = tm.decode_step(tparams, tc, _t(step).long(), _t(pos).long(),
                                image_feats=_t(feats))
        _close(tl, jl)
        step = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]
        pos = pos + 1
    got = jax.tree.leaves([{k: _np(v) for k, v in b.items()}
                           for seg in tc for b in seg.values()])
    want = jax.tree.leaves([dict(b) for seg in jc for b in seg.values()])
    assert len(got) == len(want) == 4 * 3      # k, pos, v of 4 dense
    for g, w in zip(got, want):
        _close(g, w)
    assert len(flash_calls) == 5


def test_decode_token_by_token_equals_teacher_forced_logits():
    """The JAX package's ``test_prefill_decode_consistency`` rule on
    llama-vision-smoke: a prefill of 4 tokens and 8 decode steps with
    the same image features give the forward pass's logits (JAX's
    tolerance, 2e-3); the JAX model's decode gives the port's (1e-5)."""
    jm, jparams, tm, tparams = pair()
    S, p = 12, 4
    toks = np.random.default_rng(3).integers(0, 512, (1, S)).astype(np.int32)
    feats = _feats(1, 9)
    with torch.no_grad():
        fwd, _ = tm.forward_train(tparams, {"tokens": _t(toks).long(),
                                            "image_feats": _t(feats)})
    cache = tm.make_cache(1, 32)
    jcache = jm.make_cache(1, 32)
    lg, cache = tm.prefill(tparams, {"tokens": _t(toks[:, :p]).long(),
                                     "image_feats": _t(feats)}, cache)
    _, jcache = jax.jit(jm.prefill)(jparams, {
        "tokens": jnp.asarray(toks[:, :p]),
        "image_feats": jnp.asarray(feats)}, jcache)
    _close(lg, fwd[:, p - 1], 2e-3)
    jdecode = jax.jit(jm.decode_step)
    for t in range(p, S):
        pos = np.full((1,), t, np.int32)
        lg, cache = tm.decode_step(tparams, cache, _t(toks[:, t:t + 1]).long(),
                                   _t(pos).long(), image_feats=_t(feats))
        jl, jcache = jdecode(jparams, jcache, jnp.asarray(toks[:, t:t + 1]),
                             jnp.asarray(pos), jnp.asarray(feats))
        _close(lg, fwd[:, t], 2e-3)
        _close(lg, jl)


@pytest.mark.parametrize("call", ["forward_train", "prefill", "decode_step"])
def test_cross_block_without_image_features_raises(call):
    _, _, tm, tparams = pair()
    toks = torch.zeros(1, 3, dtype=torch.long)
    with pytest.raises(ValueError, match="image_feats"):
        if call == "forward_train":
            tm.forward_train(tparams, {"tokens": toks})
        elif call == "prefill":
            tm.prefill(tparams, {"tokens": toks}, tm.make_cache(1, SLOTS))
        else:
            tm.decode_step(tparams, tm.make_cache(1, SLOTS), toks[:, :1],
                           torch.zeros(1, dtype=torch.long))


def test_shoal_step_at_two_kernels_equals_the_xla_step():
    """Two members of 2 rows each, every gradient leaf (the cross layer's
    seven included) through the ring: the same parameters and loss as
    the xla backend's one program after a step."""
    _, jparams, tm, _ = pair()
    toks = np.random.default_rng(10).integers(0, 512, (4, 8)).astype(
        np.int32)
    batch = {"tokens": _t(toks).long(),
             "labels": _t(np.roll(toks, -1, 1)).long(),
             "image_feats": _t(_feats(4, 11))}
    out = {}
    for backend, K_ in (("xla", 1), ("shoal", 2)):
        trainer = Trainer(tm, AdamWConfig(lr=1e-3),
                          TrainerConfig(comm_backend=backend), kernels=K_)
        state = trainer.state_for(params_from_numpy(
            tm.cfg, jax.device_get(jparams), device="cpu"))
        state, metrics = trainer.step(state, batch)
        out[backend] = (float(metrics["loss"]), port_arrays(state.params))
        if backend == "shoal":
            n_leaves = len(out[backend][1])
            assert trainer.ctx.exchanges == n_leaves * 2 * (K_ - 1)
    np.testing.assert_allclose(out["shoal"][0], out["xla"][0], rtol=TOL,
                               atol=TOL)
    for path, want in out["xla"][1].items():
        np.testing.assert_allclose(out["shoal"][1][path], want, rtol=TOL,
                                   atol=TOL, err_msg=path)


def test_launch_train_trains_the_vlm(tmp_path, capsys):
    """llama-vision-smoke through the launcher's shoal trainer:
    ``TokenPipeline`` draws 16 image tokens a row, the losses are
    finite."""
    import argparse

    from repro_torch.launch import train as launch_train

    _, _, _, pipe = launch_train.make_parts(argparse.Namespace(
        arch=ARCH, reduced=True, device="cpu", lr=3e-4, warmup=1, steps=3,
        backend="shoal", microbatches=1, kernels=2, batch=4, seq=16,
        seed=0))
    assert pipe.cfg.image_tokens == 16 and pipe.cfg.d_model == 96
    batch, _ = pipe.next_batch(0)
    assert batch["image_feats"].shape == (4, 16, 96)
    assert launch_train.main([
        "--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "3",
        "--batch", "4", "--seq", "16", "--log-every", "1", "--backend",
        "shoal", "--kernels", "2", "--ckpt-dir", str(tmp_path)]) == 0
    losses = [float(line.split()[4]) for line in
              capsys.readouterr().out.splitlines()
              if line.startswith("[train]")]
    assert len(losses) == 3 and all(np.isfinite(losses))
