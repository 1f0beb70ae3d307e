"""The port's ssm family (``models.xlstm``, ``configs.xlstm_350m``)
against the JAX package's, on the CPU.

In process, JAX on one device; weights drawn by the JAX package and
carried across (``params_from_numpy``), inputs from numpy with a fixed
seed; float32, rtol = atol = 1e-5 (the same operations in other orders)
unless named:

* ``init_mlstm`` / ``init_slstm``'s trees, shapes and fan-in scales
  (``conv`` x 0.1, ``r`` x 0.5 over its head axis, the sLSTM MLP width
  ``int(d * 4/3)``); ``associative_scan`` of the mLSTM's ``(f, C, n)``
  triple against ``jax.lax.associative_scan`` at odd and even lengths;
  ``_chunk_mlstm`` at S a multiple of the chunk and not (padded as
  ``mlstm_block`` pads), with and without a carried state;
  ``mlstm_block``'s three branches (training, a prefill that carries a
  state, the exact single-step decode) and a bfloat16 case (scores
  divided in bfloat16) within 2e-2 of the largest |want|; its
  gradients at chunk 256, finite where the JAX block's are NaN;
  ``slstm_block`` with and without a carried state; the fresh states;
* xlstm-smoke (8 layers: seven mLSTM blocks and one sLSTM block, d 64,
  chunk 16): the configs and xlstm-350m's 528,283,648 parameters (from
  shapes only: the JAX package's ``eval_shape`` and the port's init
  under ``FakeTensorMode``), the weight tree (``ln``, ``gn``, ``r``
  float32 in a bfloat16 model), ``forward_train``'s logits,
  ``Model.loss`` and gradients within 1e-4 of each leaf's largest
  |gradient|, prefill at 16 and 20 tokens (a padded chunk) on a bare
  ``make_cache`` (sLSTM ``m`` at -1e30) and on a lane after
  ``reset_lane`` (-30), decode steps against the JAX decode (and their
  gap to the teacher-forced logits held to the JAX package's own gap),
  a two-part prefill, ``reset_lane`` and ``ServeEngine``'s tokens
  against the JAX package's, the cache dtypes, and one shoal step at K
  2 equal to the xla step.
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
from torch._subclasses.fake_tensor import FakeTensorMode

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from serving_checks import MAX_NEW, PROMPTS  # noqa: E402
from test_torch_train import jax_arrays, port_arrays  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import xlstm as jxl  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.serving import engine as jeng  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import recurrent as trec  # noqa: E402
from repro_torch.models import xlstm as txl  # noqa: E402
from repro_torch.models.convert import (cache_from_numpy,  # noqa: E402
                                        params_from_numpy)
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.serving import engine as teng  # noqa: E402
from repro_torch.training import Trainer, TrainerConfig  # noqa: E402
from repro_torch.tree import tree_paths  # noqa: E402

ARCH = "xlstm-350m"
TOL = 1e-5
D, NH, CH = 24, 2, 8        # one block: width, heads, the mLSTM chunk
SLOTS = 16                  # unread by the ssm family's state
XLSTM_PARAMS = 528_283_648


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=tol,
                               atol=tol)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().float().numpy().copy()


def _jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


# -- the cells ----------------------------------------------------------------

@pytest.mark.parametrize("cell", ["mlstm", "slstm"])
def test_init_trees_and_scales(cell):
    """The JAX package's leaves and shapes with the layer axis in front,
    float32; ones for the norms, fan-in scales for the rest (``conv`` x
    0.1; ``r`` x 0.5 over its head axis, 0.25 at 4 heads), and at d 1024
    the JAX package's widths (pd 2048; the sLSTM MLP 1365)."""
    d, nh = 96, 4
    jinit = getattr(jxl, f"init_{cell}")
    want = jax.device_get(jax.jit(jinit, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), d, nh))
    own = getattr(txl, f"init_{cell}")(torch.Generator().manual_seed(0), d,
                                       nh, lead=(3,))
    assert sorted(own) == sorted(want)
    for k, v in want.items():
        got = own[k]
        assert got.shape == (3,) + v.shape and got.dtype == torch.float32, k
        if k in ("ln", "gn", "ln2"):
            assert bool((got == 1).all()) and (v == 1).all(), k
            continue
        fan_in = v.shape[0]
        scale = 1 / np.sqrt(fan_in) * {"conv": 0.1, "r": 0.5}.get(k, 1.0)
        assert abs(got.std().item() / scale - 1) < 0.15, k
        assert abs(v.std() / scale - 1) < 0.2, k
    full = jax.eval_shape(lambda key: jinit(key, 1024, 4),
                          jax.random.PRNGKey(0))
    with FakeTensorMode():
        tfull = getattr(txl, f"init_{cell}")(torch.Generator(), 1024, 4)
    assert {k: tuple(t.shape) for k, t in tfull.items()} \
        == {k: v.shape for k, v in full.items()}
    if cell == "slstm":
        assert tfull["wg"].shape == (1024, 1365)
        assert tfull["r"].shape == (4, 256, 1024)
    else:
        assert tfull["wq"].shape == (2048, 2048)


def _jax_combine(left, right):
    """``_chunk_mlstm``'s combine (a closure in the JAX package)."""
    fl, Cl, nl = left
    fr, Cr, nr = right
    return (fl + fr, Cr + jnp.exp(fr)[..., None, None] * Cl,
            nr + jnp.exp(fr)[..., None] * nl)


@pytest.mark.parametrize("n", [1, 2, 5, 8, 11])
def test_associative_scan_of_the_mlstm_triple_matches_jax(n):
    """The chunk memories' scan along axis 0, odd and even lengths."""
    rng = np.random.default_rng(n)
    elems = (np.log(rng.uniform(0.3, 0.95, (n, 2, 3))).astype(np.float32),
             rng.standard_normal((n, 2, 3, 4, 4)).astype(np.float32),
             rng.standard_normal((n, 2, 3, 4)).astype(np.float32))
    want = jax.jit(functools.partial(jax.lax.associative_scan,
                                     _jax_combine))(
        tuple(jnp.asarray(e) for e in elems))
    got = trec.associative_scan(txl._combine, tuple(_t(e) for e in elems))
    for g, w in zip(got, want):
        _close(g, w)


def _qkv(rng, B, S):
    q, k, v = (rng.standard_normal((B, S, NH, 8)).astype(np.float32)
               for _ in range(3))
    logf = np.log(rng.uniform(0.6, 0.95, (B, S, NH))).astype(np.float32)
    logi = (rng.standard_normal((B, S, NH)) * 2).astype(np.float32)
    return q, k, v, logf, logi


def _pad(arrs, S, chunk):
    """``mlstm_block``'s padding to a chunk multiple (numpy)."""
    pad = -S % chunk
    if not pad:
        return arrs
    q, k, v, logf, logi = (np.pad(a, [(0, 0), (0, pad)]
                                  + [(0, 0)] * (a.ndim - 2)) for a in arrs)
    logi = logi - 1e9 * (np.arange(S + pad) >= S)[None, :, None]
    return q, k, v, logf, logi.astype(np.float32)


@pytest.mark.parametrize("S", [24, 20])
@pytest.mark.parametrize("carried", [False, True])
def test_chunk_mlstm_matches_jax(S, carried):
    """h and the final (C, n, m) of the chunk form, chunk 8: S 24 (three
    chunks) and 20 (padded to 24), from nothing or a carried state."""
    rng = np.random.default_rng(S + 10 * carried)
    arrs = _pad(_qkv(rng, 2, S), S, CH)
    init = None
    if carried:
        init = (rng.standard_normal((2, NH, 8, 8)).astype(np.float32),
                rng.standard_normal((2, NH, 8)).astype(np.float32),
                rng.standard_normal((2, NH)).astype(np.float32) + 3)
    jh, jfin = jax.jit(jxl._chunk_mlstm, static_argnums=5)(
        *(jnp.asarray(a) for a in arrs), CH,
        init=None if init is None else tuple(jnp.asarray(a) for a in init))
    th, tfin = txl._chunk_mlstm(*(_t(a) for a in arrs), CH,
                                init=None if init is None
                                else tuple(_t(a) for a in init))
    _close(th[:, :S], np.asarray(jh)[:, :S])
    assert np.abs(np.asarray(jh)).max() > 1e-2
    for g, w in zip(tfin, jfin):
        _close(g, w)


@pytest.fixture(scope="module")
def cells():
    """JAX mLSTM and sLSTM weights (d 24, 2 heads) as jnp arrays, and the
    port's copies."""
    out = {}
    for name, seed in (("mlstm", 3), ("slstm", 4)):
        tree = jax.device_get(jax.jit(getattr(jxl, f"init_{name}"),
                                      static_argnums=(1, 2))(
            jax.random.PRNGKey(seed), D, NH))
        out[name] = (_jtree(tree), {k: _t(v) for k, v in tree.items()})
    return out


def _mlstm_state(rng, B):
    pd = 2 * D
    return {"C": rng.standard_normal((B, NH, pd // NH, pd // NH)).astype(
                np.float32) * 0.1,
            "n": rng.standard_normal((B, NH, pd // NH)).astype(np.float32),
            "m": rng.standard_normal((B, NH)).astype(np.float32),
            "conv": rng.standard_normal((B, 3, pd)).astype(np.float32)}


@pytest.mark.parametrize("branch,S", [("training", 20), ("decode", 1),
                                      ("prefill-carried", 16),
                                      ("prefill-carried-padded", 13)])
def test_mlstm_block_branches_match_jax(cells, branch, S):
    """The output and, with a state, the new state of each branch; the
    port writes the state in place."""
    jp, tp = cells["mlstm"]
    rng = np.random.default_rng(len(branch) + S)
    x = rng.standard_normal((2, S, D)).astype(np.float32)
    state = None if branch == "training" else _mlstm_state(rng, 2)
    jout, jstate = jax.jit(functools.partial(jxl.mlstm_block, nh=NH,
                                             chunk=CH))(
        jp, jnp.asarray(x), state=None if state is None else _jtree(state))
    tstate = None if state is None else {k: _t(v) for k, v in state.items()}
    tout, got_state = txl.mlstm_block(tp, _t(x), nh=NH, chunk=CH,
                                      state=tstate)
    _close(tout, jout)
    assert np.abs(np.asarray(jout) - x).max() > 1e-2
    if state is None:
        assert got_state is None and jstate is None
        return
    assert got_state is tstate
    for k in ("C", "n", "m", "conv"):
        assert tstate[k].dtype == torch.float32
        _close(tstate[k], jstate[k])
        assert not np.allclose(tstate[k].numpy(), state[k]), k


def test_mlstm_gradients_at_a_long_chunk_are_finite(cells):
    """At chunk 256 the masked half of the intra-chunk weights overflows
    exp (a sum of up to 255 -logf > 88): the JAX block's gradients are
    NaN there (ROADMAP section 3), the port's, which exponentiate only
    the causal half, are finite and within 1e-4 (of each leaf's largest
    |gradient|) of the JAX block's at chunk 32, where nothing
    overflows (the chunk length changes only the order of the sums)."""
    jp, tp = cells["mlstm"]
    x = np.random.default_rng(30).standard_normal((1, 256, D)).astype(
        np.float32)

    def jgrads(chunk):
        def loss(p):
            out, _ = jxl.mlstm_block(p, jnp.asarray(x), nh=NH, chunk=chunk)
            return jnp.mean(jnp.square(out))
        return {k: np.asarray(v) for k, v in
                jax.jit(jax.grad(loss))(jp).items()}

    assert any(np.isnan(v).any() for v in jgrads(256).values())
    want = jgrads(32)
    p = {k: v.clone().requires_grad_() for k, v in tp.items()}
    out, _ = txl.mlstm_block(p, _t(x), nh=NH, chunk=256)
    out.square().mean().backward()
    for k, w in want.items():
        got = p[k].grad.numpy()
        assert np.isfinite(got).all(), k
        np.testing.assert_allclose(got, w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)


def test_mlstm_block_in_bfloat16_keeps_a_float32_state(cells):
    """A bfloat16 stream (scores taken and divided by sqrt(dh) in
    bfloat16, the rest of the cell in float32), a 20-token prefill on
    the fresh state: the output within 2e-2 of the largest |want| (one
    bfloat16 rounding of a stream of O(1) values is 4e-3), the state
    float32 within 2e-2 of its largest |want|."""
    jp, tp = cells["mlstm"]
    rng = np.random.default_rng(8)
    x = rng.standard_normal((1, 20, D)).astype(np.float32)
    fresh = {k: np.asarray(v) for k, v in
             jax.device_get(jxl.make_mlstm_state(1, D, NH)).items()}
    jout, jstate = jax.jit(functools.partial(jxl.mlstm_block, nh=NH,
                                             chunk=CH))(
        jp, jnp.asarray(x, jnp.bfloat16), state=_jtree(fresh))
    tstate = {k: _t(v) for k, v in fresh.items()}
    tout, _ = txl.mlstm_block(tp, _t(x).bfloat16(), nh=NH, chunk=CH,
                              state=tstate)
    assert tout.dtype == torch.bfloat16
    want = np.asarray(jout, np.float32)
    top = np.abs(want).max()
    np.testing.assert_allclose(tout.float().numpy(), want, rtol=0,
                               atol=2e-2 * top)
    for k in ("C", "n", "m", "conv"):
        assert tstate[k].dtype == torch.float32
        w = np.asarray(jstate[k], np.float32)
        np.testing.assert_allclose(tstate[k].numpy(), w, rtol=0,
                                   atol=2e-2 * np.abs(w).max(), err_msg=k)


@pytest.mark.parametrize("carried", [False, True])
def test_slstm_block_matches_jax(cells, carried):
    """Nine steps of the time loop from the zero start (m at -1e30) or a
    carried state: the output and the last step's state."""
    jp, tp = cells["slstm"]
    rng = np.random.default_rng(20 + carried)
    x = rng.standard_normal((2, 9, D)).astype(np.float32)
    state = None
    if carried:
        state = {k: rng.standard_normal((2, D)).astype(np.float32)
                 for k in ("h", "c", "n", "m")}
        state["n"] = np.abs(state["n"]) + 0.5
    jout, jstate = jax.jit(functools.partial(jxl.slstm_block, nh=NH))(
        jp, jnp.asarray(x), state=None if state is None else _jtree(state))
    tstate = None if state is None else {k: _t(v) for k, v in state.items()}
    tout, got = txl.slstm_block(tp, _t(x), nh=NH, state=tstate)
    _close(tout, jout)
    assert np.abs(np.asarray(jout) - x).max() > 1e-2
    if state is None:
        assert got is None
        return
    assert got is tstate
    for k in ("h", "c", "n", "m"):
        _close(tstate[k], jstate[k])


@pytest.mark.parametrize("cell", ["mlstm", "slstm"])
def test_fresh_states_are_the_jax_packages(cell):
    """Float32, the layer axis in front; m at -30 (mLSTM) or -1e30
    (sLSTM), every other leaf zeros."""
    if cell == "mlstm":
        want = jxl.make_mlstm_state(2, D, NH)
        got = txl.make_mlstm_state(2, D, NH, "cpu", lead=(3,))
    else:
        want = jxl.make_slstm_state(2, D)
        got = txl.make_slstm_state(2, D, "cpu", lead=(3,))
    assert sorted(got) == sorted(want)
    for k, v in jax.device_get(want).items():
        assert got[k].shape == (3,) + v.shape and got[k].dtype \
            == torch.float32
        np.testing.assert_array_equal(got[k][1].numpy(), v)


# -- xlstm-smoke --------------------------------------------------------------

_PAIR = {}


def pair():
    """(jax model, jax params, port model, port params) of xlstm-smoke."""
    if not _PAIR:
        jm = jbuild(jconfigs.reduced(ARCH))
        tree = jax.device_get(jm.init(jax.random.PRNGKey(0)))
        tm = build_model(configs.reduced(ARCH), device="cpu")
        _PAIR["v"] = (jm, _jtree(tree), tm,
                      params_from_numpy(tm.cfg, tree, device="cpu"))
        _PAIR["jprefill"] = jax.jit(jm.prefill)
        _PAIR["jdecode"] = jax.jit(jm.decode_step)
        _PAIR["jforward"] = jax.jit(jm.forward_train)
    return _PAIR["v"]


def _toks(B, S, seed):
    return np.random.default_rng(seed).integers(0, 512, (B, S)).astype(
        np.int32)


def test_xlstm_configs_match_the_jax_package():
    """Both configs field by field and by segments, and xlstm-350m's
    528,283,648 parameters from shapes only: the JAX package's
    ``eval_shape`` of its init and the port's init under
    ``FakeTensorMode`` (nothing allocated)."""
    for name in ("full", "reduced"):
        got = getattr(configs, name)(ARCH)
        want = getattr(jconfigs, name)(ARCH)
        for f in ("name", "family", "n_layers", "d_model", "n_heads",
                  "n_kv_heads", "d_ff", "vocab", "dh", "tie_embeddings",
                  "norm", "frontend", "slstm_every", "mlstm_pf",
                  "mlstm_chunk", "sub_quadratic"):
            assert getattr(got, f) == getattr(want, f), (name, f)
        assert str(got.dtype).split(".")[-1] == jnp.dtype(want.dtype).name
        assert got.segments() == want.segments()
    full = configs.full(ARCH)
    pat = ("mlstm",) * 7 + ("slstm",)
    assert full.segments() == [(pat, 3)]
    assert configs.reduced(ARCH).segments() == [(pat, 1)]
    assert (full.n_layers, full.d_model, full.n_heads, full.vocab,
            full.mlstm_chunk, full.dtype) == (24, 1024, 4, 50304, 256,
                                              torch.bfloat16)
    shapes = jax.eval_shape(jbuild(jconfigs.full(ARCH)).init,
                            jax.random.PRNGKey(0))
    assert sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes)) \
        == XLSTM_PARAMS
    model = build_model(full, device="cpu")
    with FakeTensorMode():
        params = model.init(torch.Generator())
    assert full.num_params(params) == XLSTM_PARAMS
    assert configs.get("xlstm-350m") is configs.get("xlstm_350m")
    with pytest.raises(ValueError, match="slstm_every"):
        dataclasses.replace(full, n_layers=20).segments()


def test_weight_tree_carries_across():
    """The port's init has the JAX tree (``{"cell": ...}`` blocks, no
    ``ln1`` / ``ln2`` outside the cell), ``params_from_numpy`` carries
    every leaf, and in a bfloat16 model ``ln``, ``gn``, ``ln2``, ``r``
    and the final norm stay float32."""
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
                  if p.startswith("segments/0/b7_slstm/")) \
        == ["gn", "ln", "ln2", "r", "w", "wd", "wg", "wu"]
    assert shapes["segments/0/b0_mlstm/cell/wq"] == (1, 128, 128)
    assert shapes["segments/0/b7_slstm/cell/r"] == (1, 4, 16, 64)
    bf16 = dataclasses.replace(tm.cfg, dtype=torch.bfloat16)
    for tree in (params_from_numpy(bf16, jax.device_get(jparams),
                                   device="cpu"),
                 build_model(bf16, device="cpu").init(
                     torch.Generator().manual_seed(0))):
        for p, t in tree_paths(tree):
            f32 = p.split("/")[-1] in ("ln", "gn", "ln2", "r") \
                or "final_norm" in p
            assert t.dtype == (torch.float32 if f32 else torch.bfloat16), p


def test_cache_dtypes_and_shapes_in_a_bfloat16_model():
    """Every state leaf float32 in a bfloat16 model (cache_from_numpy
    too), the JAX package's shapes with the layer axis in front."""
    jm, _, tm, _ = pair()
    bf16 = dataclasses.replace(tm.cfg, dtype=torch.bfloat16)
    want = jax.device_get(jm.make_cache(3, SLOTS))
    for cache in (build_model(bf16, device="cpu").make_cache(3, SLOTS),
                  cache_from_numpy(bf16, want, device="cpu")):
        assert sorted(cache[0]) == sorted(want[0])
        for key, blk in cache[0].items():
            assert sorted(blk) == sorted(want[0][key])
            for name, t in blk.items():
                assert t.dtype == torch.float32, (key, name)
                assert tuple(t.shape) == want[0][key][name].shape
    cache = build_model(bf16, device="cpu").make_cache(3, SLOTS)
    assert cache[0]["b0_mlstm"]["C"].shape == (1, 3, 4, 32, 32)
    assert float(cache[0]["b0_mlstm"]["m"].max()) == -30.0
    assert float(cache[0]["b7_slstm"]["m"].max()) == np.float32(-1e30)
    assert tm.is_fresh(cache)     # a state is no slot


def test_logits_match_jax():
    """``forward_train`` at S 32 (two chunks) and 20 (padded)."""
    jm, jparams, tm, tparams = pair()
    for S in (32, 20):
        toks = _toks(2, S, S)
        jl, _ = _PAIR["jforward"](jparams, {"tokens": jnp.asarray(toks)})
        with torch.no_grad():
            tl, ta = tm.forward_train(tparams, {"tokens": _t(toks).long()})
        top = np.abs(np.asarray(jl)).max()
        _close(tl / top, np.asarray(jl) / top)
        assert float(ta) == 0.0


def test_loss_and_gradients_match_jax():
    """``Model.loss`` and every gradient leaf (the sLSTM's time loop and
    the mLSTM's chunk scan under autograd) within 1e-4 of its largest
    |gradient|."""
    jm, jparams, tm, tparams = pair()
    toks = _toks(2, 20, 6)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.loss))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        tloss = tm.loss(tparams, {k: _t(v).long() for k, v in batch.items()})
    _close(tloss, jloss)
    loss, grads = Trainer(tm, AdamWConfig(lr=1e-3)).value_and_grad(
        tparams, {k: _t(v).long() for k, v in batch.items()})
    _close(loss, jloss)
    got, want = port_arrays(grads), jax_arrays(jgrads)
    assert list(got) == list(want)
    for path in want:
        scale = np.abs(want[path]).max()
        np.testing.assert_allclose(got[path], want[path], rtol=0,
                                   atol=1e-4 * scale, err_msg=path)
    cells = [p for p in want if "/cell/" in p]
    assert len(cells) == 7 * 10 + 8
    assert all(np.abs(want[p]).max() > 0 for p in cells)


def _lane_pair(B, lane):
    """Both packages' caches of B lanes: a bare ``make_cache`` (sLSTM m at
    -1e30) or one whose every lane went through ``reset_lane`` (m at
    -30, as the engines prefill a reused lane)."""
    jm, _, tm, _ = pair()
    jcache = jm.make_cache(B, SLOTS)
    tcache = tm.make_cache(B, SLOTS)
    if lane == "reset":
        for i in range(B):
            jcache = jeng.reset_lane(jcache, i)
            teng.reset_lane(tcache, i)
    return jcache, tcache


def _same_cache(tc, jc):
    got = jax.tree.leaves([{k: _np(v) for k, v in b.items()}
                           for seg in tc for b in seg.values()])
    want = jax.tree.leaves([dict(b) for seg in jc for b in seg.values()])
    assert len(got) == len(want) == 8 * 4     # C, conv, m, n; c, h, m, n
    for g, w in zip(got, want):
        top = max(np.abs(np.asarray(w, np.float64)).max(), 1.0)
        _close(g / top, np.asarray(w, np.float64) / top)


@pytest.mark.parametrize("lane", ["bare", "reset"])
@pytest.mark.parametrize("S", [16, 20])
def test_prefill_matches_jax(S, lane):
    """A prefill of 16 (one chunk) and 20 tokens (a padded chunk) on a
    bare cache and on reset lanes: the logits, every state leaf, and the
    logits of the forward pass (the carried zero state adds nothing)."""
    jm, jparams, tm, tparams = pair()
    toks = _toks(2, S, S + 1)
    jcache, tcache = _lane_pair(2, lane)
    assert float(tcache[0]["b7_slstm"]["m"].max()) == (
        -30.0 if lane == "reset" else np.float32(-1e30))
    jl, jc = _PAIR["jprefill"](jparams, {"tokens": jnp.asarray(toks)},
                               jcache)
    tl, tc = tm.prefill(tparams, {"tokens": _t(toks).long()}, tcache)
    top = np.abs(np.asarray(jl)).max()
    _close(tl / top, np.asarray(jl) / top)
    _same_cache(tc, jc)
    with torch.no_grad():
        fwd, _ = tm.forward_train(tparams, {"tokens": _t(toks).long()})
    _close(tl / top, fwd[:, -1] / top)


def test_decode_matches_jax_and_its_gap_to_the_forward_pass():
    """Prefill 16 tokens, then 8 decode steps: every step's logits
    within 1e-5 of the JAX decode's, the states equal after the last.
    Decode (the stabilized recurrence, floor exp(-m_t)) and the
    teacher-forced chunk form (floor exp(-M)) are not the same float32
    function; their gap is held to the JAX package's own gap on the
    same inputs, not to an absolute bound."""
    jm, jparams, tm, tparams = pair()
    S, end = 16, 24
    toks = _toks(2, end, 40)
    jcache, tcache = _lane_pair(2, "bare")
    jl, jc = _PAIR["jprefill"](jparams, {"tokens": jnp.asarray(toks[:, :S])},
                               jcache)
    tl, tc = tm.prefill(tparams, {"tokens": _t(toks[:, :S]).long()}, tcache)
    jfwd, _ = _PAIR["jforward"](jparams, {"tokens": jnp.asarray(toks)})
    jfwd = np.asarray(jfwd)
    with torch.no_grad():
        tfwd, _ = tm.forward_train(tparams, {"tokens": _t(toks).long()})
    jgap = tgap = 0.0
    for t in range(S, end):
        pos = np.full((2,), t, np.int32)
        jl, jc = _PAIR["jdecode"](jparams, jc, jnp.asarray(toks[:, t:t + 1]),
                                  jnp.asarray(pos))
        tl, tc = tm.decode_step(tparams, tc, _t(toks[:, t:t + 1]).long(),
                                _t(pos).long())
        top = np.abs(np.asarray(jl)).max()
        _close(tl / top, np.asarray(jl) / top)
        jgap = max(jgap, np.abs(np.asarray(jl) - jfwd[:, t]).max() / top)
        tgap = max(tgap, (tl - tfwd[:, t]).abs().max().item() / top)
    _same_cache(tc, jc)
    assert tgap <= jgap + TOL, (tgap, jgap)


def test_two_part_prefill_matches_jax():
    """16 tokens, then 20 more on the written lanes (the carried state
    through ``_chunk_mlstm``'s ``init`` and the sLSTM loop): the logits
    and every state leaf against the JAX package's two-part prefill."""
    jm, jparams, tm, tparams = pair()
    toks = _toks(2, 36, 7)
    jc, tc = _lane_pair(2, "reset")
    for part in (toks[:, :16], toks[:, 16:]):
        jl, jc = _PAIR["jprefill"](jparams, {"tokens": jnp.asarray(part)},
                                   jc)
        tl, tc = tm.prefill(tparams, {"tokens": _t(part).long()}, tc)
        top = np.abs(np.asarray(jl)).max()
        _close(tl / top, np.asarray(jl) / top)
    _same_cache(tc, jc)


def test_reset_lane_matches_the_jax_engines():
    """A written lane reset in both packages: every ``m`` to -30 (the
    sLSTM's too), the other state leaves to 0, the other lane
    untouched."""
    jm, jparams, tm, tparams = pair()
    toks = _toks(2, 16, 11)
    jcache, tcache = _lane_pair(2, "bare")
    _, jc = _PAIR["jprefill"](jparams, {"tokens": jnp.asarray(toks)},
                              jcache)
    tm.prefill(tparams, {"tokens": _t(toks).long()}, tcache)
    want = jeng.reset_lane(jc, 1)
    teng.reset_lane(tcache, 1)
    _same_cache(tcache, want)
    for key, names in (("b0_mlstm", ("C", "n", "conv")),
                       ("b7_slstm", ("h", "c", "n"))):
        st = tcache[0][key]
        assert float(st["m"][:, 1].max()) == float(st["m"][:, 1].min()) \
            == -30.0
        assert all(not st[n][:, 1].any() and st[n][:, 0].any()
                   for n in names)


def test_engine_serves_the_jax_engines_tokens():
    """Six ragged prompts on 2 lanes (lane reuse: the reset writes m =
    -30 into a reused lane's sLSTM state), greedy."""
    jm, jparams, tm, tparams = pair()
    want = jeng.ServeEngine(jm, jparams, lanes=2, slots=SLOTS).run(
        [jeng.Request(i, np.asarray(p, np.int32), m)
         for i, (p, m) in enumerate(zip(PROMPTS, MAX_NEW))])
    eng = teng.ServeEngine(tm, tparams, lanes=2, slots=SLOTS)
    done = eng.run([teng.Request(i, np.asarray(p, np.int32), m)
                    for i, (p, m) in enumerate(zip(PROMPTS, MAX_NEW))])
    assert [(r.rid, r.out) for r in done] == [(r.rid, r.out) for r in want]
    assert [len(r.out) for r in sorted(done, key=lambda r: r.rid)] == MAX_NEW


def test_shoal_step_at_two_kernels_equals_the_xla_step():
    """Two members of 2 rows each, every gradient leaf (the cells' 78
    and the embedding, head and final norm) through the ring: the loss
    and the synced gradients within 1e-5 (of each leaf's largest
    |gradient|) of the xla backend's one program, and the parameters
    after the step within 1e-5 wherever the gradient is above 1e-4 of
    its leaf's largest.  Below that the two gradients are float32 noise
    of a near-zero sum (members summed in another order), and AdamW's
    first step, lr * g / (|g| + 1e-8), moves such an element by up to lr
    either way: there only |difference| <= 2 lr is held."""
    _, jparams, tm, _ = pair()
    toks = _toks(4, 20, 10)
    batch = {"tokens": _t(toks).long(),
             "labels": _t(np.roll(toks, -1, 1)).long()}
    lr = 1e-3
    out = {}
    for backend, K_ in (("xla", 1), ("shoal", 2)):
        trainer = Trainer(tm, AdamWConfig(lr=lr),
                          TrainerConfig(comm_backend=backend), kernels=K_)
        state = trainer.state_for(params_from_numpy(
            tm.cfg, jax.device_get(jparams), device="cpu"))
        _, grads, _ = trainer.grads(state, batch)
        state, metrics = trainer.step(state, batch)
        out[backend] = (float(metrics["loss"]), port_arrays(grads),
                        port_arrays(state.params))
        if backend == "shoal":
            n_leaves = len(out[backend][2])
            assert n_leaves == 7 * 10 + 8 + 3
            # two syncs (grads, then the step's), one ring a leaf each
            assert trainer.ctx.exchanges == 2 * n_leaves * 2 * (K_ - 1)
    np.testing.assert_allclose(out["shoal"][0], out["xla"][0], rtol=TOL,
                               atol=TOL)
    for path, g in out["xla"][1].items():
        top = np.abs(g).max()
        np.testing.assert_allclose(out["shoal"][1][path], g, rtol=0,
                                   atol=TOL * top, err_msg=path)
        firm = np.abs(g) > 1e-4 * top
        want, got = out["xla"][2][path], out["shoal"][2][path]
        np.testing.assert_allclose(got[firm], want[firm], rtol=TOL,
                                   atol=TOL, err_msg=path)
        assert np.abs(got - want).max() <= 2 * lr, path
