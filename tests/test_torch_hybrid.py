"""The port's hybrid family (``models.recurrent``, the windowed attention
of ``models.attention`` and its ring cache, ``configs.recurrentgemma_2b``)
against the JAX package's, on the CPU.

In process, JAX on one device; weights drawn by the JAX package and
carried across (``params_from_numpy``), inputs from numpy with a fixed
seed; float32, rtol = atol = 1e-5 (the same operations in other orders)
unless named:

* ``init_rglru``'s tree, its fan-in scales and its ``lam`` draw (``a =
  exp(-8 softplus(lam))`` in 0.9 .. 0.999); ``_block_diag``,
  ``_conv1d_causal`` (with and without a carried state), ``_lru_scan``
  (the log-depth scan and the sequential one) and ``rglru_block``'s
  three state branches (training, a decode step, a chunked prefill that
  carries a state on) against ``repro.models.recurrent``;
* ``_attend`` with ``window`` and ``logit_cap`` against the JAX
  ``_attend``; ``gqa(window=)``'s routes against the JAX ``gqa``,
  counting the calls that reach ``flash_attention``;
* recurrentgemma-smoke (5 layers: a superblock of two RG-LRU blocks and
  a local-attention block, and a remainder of two RG-LRU blocks; window
  16): the configs, the weight tree (``lam`` float32 in a bfloat16
  model), ``forward_train``'s logits, ``Model.loss`` and gradients
  within 1e-4 of each leaf's largest |gradient|, prefill at 12, 16 and
  24 tokens (24 > the window: the JAX package keeps the last 16 keys
  and attends every query to them, ROADMAP §3, and the port mirrors
  it), decode through the ring's wrap to position 40, decode token by
  token equal to the teacher-forced logits, ``ServeEngine``'s tokens
  equal to the JAX engine's (lane reuse, ``reset_lane`` zeroing the
  RG-LRU state), and one shoal step at K 2 equal to the xla step.
"""

import dataclasses
import functools
import os
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
from repro.models import recurrent as jrec  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.serving import engine as jeng  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import recurrent as trec  # noqa: E402
from repro_torch.models.convert import (cache_from_numpy,  # noqa: E402
                                        params_from_numpy)
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.serving import engine as teng  # noqa: E402
from repro_torch.training import Trainer, TrainerConfig  # noqa: E402
from repro_torch.tree import tree_paths  # noqa: E402

ARCH = "recurrentgemma-2b"
TOL = 1e-5
W = 16                      # recurrentgemma-smoke's window
D, DR, NB = 24, 32, 4       # one RG-LRU block: width, LRU width, gate blocks


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=tol,
                               atol=tol)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    t = t.detach()
    return (t if t.dtype == torch.int32 else t.float()).numpy().copy()


@pytest.fixture
def flash_calls(monkeypatch):
    """The q shapes of the attention calls that take the kernel route."""
    calls = []
    real = tattn.flash_attention

    def counted(q, k, v, causal=True):
        calls.append(tuple(q.shape))
        return real(q, k, v, causal=causal)

    monkeypatch.setattr(tattn, "flash_attention", counted)
    return calls


# -- the RG-LRU block -----------------------------------------------------------

def test_init_rglru_tree_and_scales():
    """Seven leaves, the JAX package's shapes with the layer axis in
    front, fan-in scales (the gates' over their block, axis 1), and
    ``lam`` drawn so ``a`` starts in 0.9 .. 0.999."""
    want = jax.device_get(jrec.init_rglru(jax.random.PRNGKey(0), 96, 128, 4))
    own = trec.init_rglru(torch.Generator().manual_seed(0), 96, 128, 4,
                          lead=(3,))
    assert sorted(own) == sorted(want) == ["conv", "lam", "wi", "wo", "wr",
                                           "wx", "wy"]
    for k, v in want.items():
        got = own[k]
        assert got.shape == (3,) + v.shape and got.dtype == torch.float32, k
        if k == "lam":
            for lam in (got.numpy(), v):
                a = np.exp(-8.0 * np.logaddexp(lam, 0.0))
                assert a.min() >= 0.9 - 1e-6 and a.max() <= 0.999 + 1e-6
                assert a.max() - a.min() > 0.05
            continue
        fan_in = v.shape[1] if k in ("wr", "wi") else v.shape[0]
        scale = 1 / np.sqrt(fan_in) * (0.1 if k == "conv" else 1.0)
        assert abs(got.std().item() / scale - 1) < 0.15, k
        assert abs(v.std() / scale - 1) < 0.2, k


@pytest.fixture(scope="module")
def rnn():
    """JAX ``init_rglru`` weights as jnp arrays, and the port's copy."""
    tree = jax.device_get(jrec.init_rglru(jax.random.PRNGKey(3), D, DR, NB))
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            {k: _t(v) for k, v in tree.items()})


def test_block_diag_matches_jax(rnn):
    jp, tp = rnn
    x = np.random.default_rng(1).standard_normal((2, 5, DR)).astype(
        np.float32)
    _close(trec._block_diag(_t(x), tp["wr"]),
           jrec._block_diag(jnp.asarray(x), jp["wr"]))


@pytest.mark.parametrize("S", [1, 6])
@pytest.mark.parametrize("carried", [False, True])
def test_conv1d_causal_matches_jax(rnn, S, carried):
    """Output and new trailing state, from zeros or a carried state."""
    jp, tp = rnn
    rng = np.random.default_rng(S + carried)
    x = rng.standard_normal((2, S, DR)).astype(np.float32)
    st = rng.standard_normal((2, 3, DR)).astype(np.float32) if carried \
        else None
    want = jrec._conv1d_causal(jnp.asarray(x), jp["conv"],
                               None if st is None else jnp.asarray(st))
    got = trec._conv1d_causal(_t(x), tp["conv"],
                              None if st is None else _t(st))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("S", [1, 2, 7, 16, 33])
@pytest.mark.parametrize("scan", ["log-depth", "sequential"])
def test_lru_scan_matches_jax(S, scan):
    """``h_t = a_t h_{t-1} + b_t`` against the JAX associative scan, at
    even, odd and power-of-two lengths."""
    rng = np.random.default_rng(S)
    a = rng.uniform(0.8, 1.0, (2, S, 8)).astype(np.float32)
    b = rng.standard_normal((2, S, 8)).astype(np.float32)
    want = jrec._lru_scan(jnp.asarray(a), jnp.asarray(b))
    fn = trec._lru_scan if scan == "log-depth" else trec._lru_scan_sequential
    _close(fn(_t(a), _t(b)), want)


@pytest.mark.parametrize("branch,S", [("training", 9), ("decode", 1),
                                      ("chunked-prefill", 7)])
def test_rglru_block_branches_match_jax(rnn, branch, S):
    """The output and, with a state, the new state (h float32, conv) of
    each branch; the port writes the state in place."""
    jp, tp = rnn
    rng = np.random.default_rng(len(branch))
    x = rng.standard_normal((2, S, D)).astype(np.float32)
    state = None
    if branch != "training":
        state = {"h": rng.standard_normal((2, DR)).astype(np.float32),
                 "conv": rng.standard_normal((2, 3, DR)).astype(np.float32)}
    jout, jstate = jax.jit(jrec.rglru_block)(
        jp, jnp.asarray(x),
        state=None if state is None else jax.tree.map(jnp.asarray, state))
    tstate = None if state is None else {k: _t(v) for k, v in state.items()}
    tout, got_state = trec.rglru_block(tp, _t(x), state=tstate)
    _close(tout, jout)
    assert np.abs(np.asarray(jout)).max() > 1e-2
    if state is None:
        assert got_state is None
        return
    assert got_state is tstate and tstate["h"].dtype == torch.float32
    for k in ("h", "conv"):
        _close(tstate[k], jstate[k])
        assert not np.allclose(tstate[k].numpy(), state[k])


def test_rglru_block_in_bfloat16_keeps_a_float32_state(rnn):
    """A bfloat16 stream: sigmoids in bfloat16, the recurrence in float32,
    the state float32; within 3e-2 of the JAX block."""
    jp, tp = rnn
    rng = np.random.default_rng(8)
    x = rng.standard_normal((1, 5, D)).astype(np.float32)
    zeros = {"h": np.zeros((1, DR), np.float32),
             "conv": np.zeros((1, 3, DR), np.float32)}
    jout, jstate = jax.jit(jrec.rglru_block)(
        jp, jnp.asarray(x, jnp.bfloat16),
        state=jax.tree.map(jnp.asarray, zeros))
    tstate = {k: _t(v) for k, v in zeros.items()}
    tout, _ = trec.rglru_block(tp, _t(x).bfloat16(), state=tstate)
    assert tout.dtype == torch.bfloat16
    assert tstate["h"].dtype == tstate["conv"].dtype == torch.float32
    _close(tout.float(), np.asarray(jout, np.float32), 3e-2)
    _close(tstate["h"], jstate["h"], 3e-2)


def test_make_rglru_state_is_float32_zeros():
    st = trec.make_rglru_state(2, 8, "cpu", lead=(3,))
    want = jrec.make_rglru_state(2, 8)
    for k, v in want.items():
        assert st[k].shape == (3,) + v.shape
        assert st[k].dtype == torch.float32 and not st[k].any()


# -- windowed attention --------------------------------------------------------

@pytest.mark.parametrize("window,cap", [(0, 0.0), (4, 0.0), (0, 2.5),
                                        (5, 1.5), (1, 0.0)])
def test_attend_with_window_and_logit_cap_matches_jax(window, cap):
    """Over a ring with unwritten, stale and future slots; at window 1
    some rows see no slot and take the uniform average, as in the JAX
    package (the fill is -1e30, not -inf)."""
    rng = np.random.default_rng(window * 10 + int(cap * 10))
    B, S, K, G, T, dh = 2, 5, 2, 2, 12, 8
    q = rng.standard_normal((B, S, K, G, dh)).astype(np.float32) * 3
    k, v = (rng.standard_normal((B, T, K, dh)).astype(np.float32)
            for _ in range(2))
    q_pos = (np.array([[9], [4]]) + np.arange(S)).astype(np.int32)
    k_pos = rng.integers(-1, 14, (B, T)).astype(np.int32)
    want = jattn._attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         jnp.asarray(q_pos), jnp.asarray(k_pos),
                         window=window, logit_cap=cap)
    got = tattn._attend(*(_t(a) for a in (q, k, v, q_pos, k_pos)),
                        window=window, logit_cap=cap)
    assert bool(torch.isfinite(got).all())
    _close(got, want)
    if window == 1:     # a row whose own position has no slot
        empty = ~((k_pos[:, None, :] == q_pos[:, :, None]).any(-1))
        assert empty.any()


@pytest.fixture(scope="module")
def layer():
    tree = jax.device_get(jattn.init_gqa(jax.random.PRNGKey(5), 40, 4, 1, 8))
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            {k: _t(v) for k, v in tree.items()})


# route -> (S, cache slots or None, prior cache entries, port kwargs,
# kernel calls): window 6
GQA_ROUTES = {
    "kernel-prompt-within-window": (6, None, 0, {}, 1),
    "plain-prompt-past-window": (9, None, 0, {}, 0),
    "plain-differentiable": (5, None, 0, {"differentiable": True}, 0),
    "kernel-fresh-ring": (6, 6, 0, {"fresh": True}, 1),
    "plain-prompt-past-ring": (9, 6, 0, {"fresh": True}, 0),
    "plain-fresh-ring-wider-than-window": (9, 16, 0, {"fresh": True}, 0),
    "plain-written-ring": (3, 6, 5, {}, 0),
    "plain-decode-across-wrap": (1, 6, 8, {}, 0),
}


@pytest.mark.parametrize("route", list(GQA_ROUTES))
def test_gqa_window_routes_match_jax(layer, flash_calls, route):
    """Each route of ``gqa(window=6)`` (MQA, 4 query heads over 1 kv
    head) against the JAX ``gqa``; the cache written in place equals the
    JAX package's new cache."""
    jp, tp = layer
    S, slots, prior, kwargs, n_flash = GQA_ROUTES[route]
    B, H, K, dh, win = 2, 4, 1, 8, 6
    rng = np.random.default_rng(len(route))
    x = rng.standard_normal((B, S, 40)).astype(np.float32)
    pos = (prior + np.arange(S))[None].repeat(B, 0).astype(np.int32)
    jcache = tcache = None
    if slots is not None:
        jcache = jattn.make_kv_cache(B, slots, K, dh, jnp.float32)
        if prior:   # the earlier entries, written as a prefill would
            old = rng.standard_normal((2, B, prior, K, dh)).astype(
                np.float32)
            p0 = np.arange(prior)[None].repeat(B, 0).astype(np.int32)
            keep = slice(-slots, None) if prior > slots else slice(None)
            jcache = jattn._ring_write(jcache, jnp.asarray(old[0][:, keep]),
                                       jnp.asarray(old[1][:, keep]),
                                       jnp.asarray(p0[:, keep]))
        tcache = {k: _t(jax.device_get(v)) for k, v in jcache.items()}
    want, wcache = jax.jit(functools.partial(
        jattn.gqa, H=H, K=K, dh=dh, window=win))(
        jp, jnp.asarray(x), jnp.asarray(pos), cache=jcache)
    got, gcache = tattn.gqa(tp, _t(x), _t(pos), H=H, K=K, dh=dh, window=win,
                            cache=tcache, **kwargs)
    _close(got.detach(), want)
    assert len(flash_calls) == n_flash
    if slots is not None:
        assert gcache is tcache
        for k in ("k", "v", "pos"):
            _close(_np(tcache[k]), wcache[k])


def test_plain_prompt_past_window_differs_from_unwindowed(layer):
    """The window acts: a 9-token prompt at window 6 differs from the
    same prompt unwindowed after position 5, and equals it before."""
    _, tp = layer
    x = _t(np.random.default_rng(9).standard_normal((1, 9, 40)).astype(
        np.float32))
    pos = torch.arange(9)[None]
    windowed, _ = tattn.gqa(tp, x, pos, H=4, K=1, dh=8, window=6)
    full, _ = tattn.gqa(tp, x, pos, H=4, K=1, dh=8)
    torch.testing.assert_close(windowed[:, :6], full[:, :6])
    assert (windowed[:, 6:] - full[:, 6:]).abs().max().item() > 1e-3


# -- recurrentgemma-smoke -----------------------------------------------------

_PAIR = {}


def pair():
    """(jax model, jax params, port model, port params) of
    recurrentgemma-smoke."""
    if not _PAIR:
        jm = jbuild(jconfigs.reduced(ARCH))
        tree = jax.device_get(jm.init(jax.random.PRNGKey(0)))
        tm = build_model(configs.reduced(ARCH), device="cpu")
        _PAIR["v"] = (jm, jax.tree.map(jnp.asarray, tree), tm,
                      params_from_numpy(tm.cfg, tree, device="cpu"))
        _PAIR["jprefill"] = jax.jit(jm.prefill)
        _PAIR["jdecode"] = jax.jit(jm.decode_step)
        _PAIR["jforward"] = jax.jit(jm.forward_train)
    return _PAIR["v"]


def _toks(B, S, seed):
    return np.random.default_rng(seed).integers(0, 512, (B, S)).astype(
        np.int32)


def test_hybrid_configs_match_the_jax_package():
    for name in ("full", "reduced"):
        got = getattr(configs, name)(ARCH)
        want = getattr(jconfigs, name)(ARCH)
        for f in ("name", "family", "n_layers", "d_model", "n_heads",
                  "n_kv_heads", "d_ff", "vocab", "dh", "dr", "qkv_bias",
                  "tie_embeddings", "rope_base", "norm", "mlp", "frontend",
                  "block_pattern", "window", "lru_width", "sub_quadratic"):
            assert getattr(got, f) == getattr(want, f), (name, f)
        assert str(got.dtype).split(".")[-1] == jnp.dtype(want.dtype).name
        assert got.segments() == want.segments()
    full = configs.full(ARCH)
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.dh, full.d_ff, full.vocab, full.window, full.dr,
            full.dtype) == (26, 2560, 10, 1, 256, 7680, 256000, 2048, 2560,
                            torch.bfloat16)
    pat = ("rglru", "rglru", "attn_local")
    assert full.segments() == [(pat, 8), (pat[:2], 1)]
    assert configs.reduced(ARCH).segments() == [(pat, 1), (pat[:2], 1)]
    assert dataclasses.replace(full, n_layers=3).segments() == [(pat, 1)]
    assert configs.get("recurrentgemma-2b") is configs.get(
        "recurrentgemma_2b")


def test_weight_tree_carries_across():
    """The port's init has the JAX tree (seven RG-LRU leaves under
    ``rnn``), ``params_from_numpy`` carries every leaf, and in a
    bfloat16 model ``lam`` stays float32 beside the norms."""
    jm, jparams, tm, tparams = pair()
    own = tm.init(torch.Generator().manual_seed(0))
    shapes = {p: tuple(t.shape) for p, t in tree_paths(own)}
    want = jax_arrays(jparams)
    got = port_arrays(tparams)
    assert list(shapes) == list(want) == list(got)
    for p, a in want.items():
        assert shapes[p] == a.shape, p
        np.testing.assert_array_equal(got[p], a, err_msg=p)
    assert sorted(p.split("/")[-1] for p in shapes
                  if "/b0_rglru/rnn/" in p and p.startswith("segments/0")) \
        == ["conv", "lam", "wi", "wo", "wr", "wx", "wy"]
    assert shapes["segments/0/b0_rglru/rnn/wr"] == (1, 5, 16, 16)
    assert shapes["segments/1/b1_rglru/rnn/lam"] == (1, 80)
    bf16 = dataclasses.replace(tm.cfg, dtype=torch.bfloat16)
    for tree in (params_from_numpy(bf16, jax.device_get(jparams),
                                   device="cpu"),
                 build_model(bf16, device="cpu").init(
                     torch.Generator().manual_seed(0))):
        for p, t in tree_paths(tree):
            f32 = p.endswith("/lam") or "ln1" in p or "ln2" in p \
                or "final_norm" in p
            assert t.dtype == (torch.float32 if f32 else torch.bfloat16), p


def test_logits_and_loss_match_jax(flash_calls):
    """``forward_train`` at S 12 <= the window (the local layer on the
    kernel route) and S 20 > it (the plain route with the window), and
    ``Model.loss`` (the plain route)."""
    jm, jparams, tm, tparams = pair()
    for S, n_flash in ((12, 1), (20, 0)):
        toks = _toks(2, S, S)
        jl, _ = _PAIR["jforward"](jparams, {"tokens": jnp.asarray(toks)})
        with torch.no_grad():
            tl, ta = tm.forward_train(tparams, {"tokens": _t(toks).long()})
        top = np.abs(np.asarray(jl)).max()
        _close(tl / top, np.asarray(jl) / top)
        assert float(ta) == 0.0
        assert len(flash_calls) == n_flash
        flash_calls.clear()
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    jloss = jax.jit(jm.loss)(jparams, {k: jnp.asarray(v)
                                       for k, v in batch.items()})
    with torch.no_grad():
        tloss = tm.loss(tparams, {k: _t(v).long() for k, v in batch.items()})
    _close(tloss, jloss)
    assert not flash_calls


def test_gradients_match_jax():
    jm, jparams, tm, tparams = pair()
    toks = _toks(2, 20, 6)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.loss))(
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
    rnn = [p for p in want if "/rnn/" in p]
    assert len(rnn) == 4 * 7 and all(np.abs(want[p]).max() > 0 for p in rnn)


def _prefill_pair(toks, slots):
    jm, jparams, tm, tparams = pair()
    jcache = jm.make_cache(toks.shape[0], slots)
    tcache = cache_from_numpy(tm.cfg, jax.device_get(jcache), device="cpu")
    jl, jc = _PAIR["jprefill"](jparams, {"tokens": jnp.asarray(toks)},
                               jcache)
    tl, tc = tm.prefill(tparams, {"tokens": _t(toks).long()}, tcache)
    return jl, jc, tl, tc


def _same_cache(tc, jc):
    got = jax.tree.leaves([{k: _np(v) for k, v in b.items()}
                           for seg in tc for b in seg.values()])
    want = jax.tree.leaves([dict(b) for seg in jc for b in seg.values()])
    assert len(got) == len(want) == 4 * 2 + 3   # h, conv; k, pos, v
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("S,n_flash", [(12, 1), (16, 1), (24, 0)])
def test_prefill_matches_jax(flash_calls, S, n_flash):
    """A fresh prefill on the window's 16 slots: the logits and every
    cache leaf (ring, RG-LRU state).  At 24 > 16 tokens only the last 16
    keys are kept and every query attends to them (the JAX package's
    quirk, mirrored): the last logits then differ from the forward
    pass's, which they equal at 12 and 16."""
    jm, jparams, tm, tparams = pair()
    toks = _toks(2, S, S + 1)
    jl, jc, tl, tc = _prefill_pair(toks, W)
    top = np.abs(np.asarray(jl)).max()
    _close(tl / top, np.asarray(jl) / top)
    _same_cache(tc, jc)
    assert tc[0]["b0_rglru"]["h"].dtype == torch.float32
    assert len(flash_calls) == n_flash
    with torch.no_grad():
        fwd, _ = tm.forward_train(tparams, {"tokens": _t(toks).long()},
                                  differentiable=True)
    gap = (tl - fwd[:, -1]).abs().max().item()
    assert (gap > 1e-2) if S > W else (gap < 1e-5 * top + 1e-6)


def test_decode_through_the_ring_wrap_matches_jax():
    """Prefill 12 tokens on 16 slots, then decode to position 40: the ring
    wraps twice and the window masks; every step's logits within 1e-5 of
    the JAX package's and of the teacher-forced pass, the caches equal
    after the last step."""
    jm, jparams, tm, tparams = pair()
    S, end = 12, 41
    toks = _toks(1, end, 40)
    jl, jc, tl, tc = _prefill_pair(toks[:, :S], W)
    with torch.no_grad():
        fwd, _ = tm.forward_train(tparams, {"tokens": _t(toks).long()},
                                  differentiable=True)
    for t in range(S, end):
        pos = np.full((1,), t, np.int32)
        jl, jc = _PAIR["jdecode"](jparams, jc, jnp.asarray(toks[:, t:t + 1]),
                                  jnp.asarray(pos))
        tl, tc = tm.decode_step(tparams, tc, _t(toks[:, t:t + 1]).long(),
                                _t(pos).long())
        top = np.abs(np.asarray(jl)).max()
        _close(tl / top, np.asarray(jl) / top)
        _close(tl / top, fwd[:, t] / top)
    _same_cache(tc, jc)
    ring = tc[0]["b2_attn_local"]["pos"][0, 0]
    assert sorted(ring.tolist()) == list(range(end - W, end))


def test_decode_token_by_token_equals_teacher_forced_logits():
    """``tests/test_arch_smoke.py``'s hybrid rule on the port: a prefill
    of 3 tokens on ``window`` slots and 7 decode steps give the forward
    pass's logits (its tolerance, 5e-3; here within 1e-5)."""
    _, _, tm, tparams = pair()
    toks = _toks(1, 10, 4)
    with torch.no_grad():
        fwd, _ = tm.forward_train(tparams, {"tokens": _t(toks).long()})
    cache = tm.make_cache(1, tm.cfg.window)
    lg, cache = tm.prefill(tparams, {"tokens": _t(toks[:, :3]).long()}, cache)
    _close(lg, fwd[:, 2], 5e-3)
    for t in range(3, 10):
        lg, cache = tm.decode_step(tparams, cache, _t(toks[:, t:t + 1]).long(),
                                   torch.full((1,), t))
        _close(lg, fwd[:, t], 5e-3)
        top = fwd[:, t].abs().max().item()
        _close(lg / top, fwd[:, t] / top)


def test_cache_has_a_ring_of_the_window_and_a_float32_state():
    _, _, tm, _ = pair()
    bf16 = build_model(dataclasses.replace(tm.cfg, dtype=torch.bfloat16),
                       device="cpu")
    cache = bf16.make_cache(3, 64)
    local = cache[0]["b2_attn_local"]
    assert local["k"].shape == (1, 3, W, 1, 32) and local["k"].dtype \
        == torch.bfloat16
    st = cache[1]["b1_rglru"]
    assert st["h"].shape == (1, 3, 80) and st["conv"].shape == (1, 3, 3, 80)
    assert st["h"].dtype == st["conv"].dtype == torch.float32
    assert tm.is_fresh(cache)
    st["h"].fill_(1.0)              # a state is no slot
    assert tm.is_fresh(cache)
    local["pos"][0, 1, 0] = 4
    assert not tm.is_fresh(cache)


def test_engine_serves_the_jax_engines_tokens():
    """Six ragged prompts on 2 lanes of 16 slots (lane reuse: the RG-LRU
    state and the ring of a reused lane are reset), greedy."""
    jm, jparams, tm, tparams = pair()
    want = jeng.ServeEngine(jm, jparams, lanes=2, slots=W).run(
        [jeng.Request(i, np.asarray(p, np.int32), m)
         for i, (p, m) in enumerate(zip(PROMPTS, MAX_NEW))])
    eng = teng.ServeEngine(tm, tparams, lanes=2, slots=W)
    done = eng.run([teng.Request(i, np.asarray(p, np.int32), m)
                    for i, (p, m) in enumerate(zip(PROMPTS, MAX_NEW))])
    assert [(r.rid, r.out) for r in done] == [(r.rid, r.out) for r in want]
    assert [len(r.out) for r in sorted(done, key=lambda r: r.rid)] == MAX_NEW


def test_reset_lane_zeroes_the_state_as_the_jax_engine_does():
    """A written lane reset in both packages: ``h`` and ``conv`` to the
    JAX init (zeros), ``pos`` to -1, the other lane untouched."""
    jm, jparams, tm, tparams = pair()
    toks = _toks(2, 7, 11)
    _, jc, _, tc = _prefill_pair(toks, W)
    want = jeng.reset_lane(jc, 1)
    teng.reset_lane(tc, 1)
    _same_cache(tc, want)
    st = tc[0]["b1_rglru"]
    assert not st["h"][:, 1].any() and not st["conv"][:, 1].any()
    assert st["h"][:, 0].abs().max().item() > 0
    lane = teng.lane_slice(tc, 0)
    assert sorted(lane[1]["b0_rglru"]) == ["conv", "h"]
    assert lane[1]["b0_rglru"]["h"].shape == (1, 1, 80)
    other = [{k: {n: torch.zeros_like(t) for n, t in blk.items()}
              for k, blk in seg.items()} for seg in lane]
    teng.lane_write(tc, other, 0)
    assert not tc[1]["b0_rglru"]["h"][:, 0].any()


def test_shoal_step_at_two_kernels_equals_the_xla_step():
    """Two members of 2 rows each, every gradient leaf (the RG-LRU's
    included) through the ring: the same parameters and loss as the xla
    backend's one program after a step."""
    _, jparams, tm, _ = pair()
    toks = _toks(4, 8, 10)
    batch = {"tokens": _t(toks).long(),
             "labels": _t(np.roll(toks, -1, 1)).long()}
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
