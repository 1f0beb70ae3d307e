"""The port's LM serving stack against the JAX package's, on the CPU.

tinyllama-smoke (``configs.reduced("tinyllama-1.1b")``: 2 layers,
d_model 64, 4 heads, 2 kv heads, float32): the JAX package's
``Model.init`` weights are carried across with ``params_from_numpy``,
and the port's ``prefill`` / ``decode_step`` logits must agree with the
JAX model's within rtol = atol = 1e-5 (the same float32 operations, in
other orders).  ``ServeEngine.run`` on the six ragged prompts of
``tests/serving_checks.py`` with 2 lanes and 16 slots must give exactly
the JAX engine's tokens (lane reuse, more requests than lanes).  The
bfloat16 variant is held within 3e-2 of the largest |logit| (the two
frameworks round bfloat16 at other places: the JAX model's attention
rounds its scores to bfloat16, the flash route does not).

On the CPU the flash route runs the kernel's plain version; the tests
count which route each attention call takes by wrapping the function.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import blocks as jbl
from repro.models.model import build_model as jbuild
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeEngine as JEngine
from repro_torch import configs
from repro_torch.models import attention as tattn
from repro_torch.models import blocks as tbl
from repro_torch.models.convert import cache_from_numpy, params_from_numpy
from repro_torch.models.model import build_model
from repro_torch.serving import engine as teng
from serving_checks import MAX_NEW, PROMPTS

ARCH = "tinyllama-1.1b"
SLOTS = 16
TOL = 1e-5
RNG = np.random.default_rng(3)


def _np(tree):
    """A port tree (params or cache) as float32/int32 numpy leaves."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_np(v) for v in tree]
    t = tree.detach().cpu()
    return (t if t.dtype == torch.int32 else t.float()).numpy()


def _jnp_tree(tree):
    return jax.tree.map(lambda a: np.asarray(
        a, np.int32 if a.dtype == np.int32 else np.float32),
        jax.device_get(tree))


class Pair:
    """One configuration in both packages, the JAX weights carried over."""

    def __init__(self, jcfg, tcfg, seed=0):
        self.jcfg, self.tcfg = jcfg, tcfg
        self.jm = jbuild(jcfg)
        self.jparams = self.jm.init(jax.random.PRNGKey(seed))
        self.tm = build_model(tcfg, device="cpu")
        self.tparams = params_from_numpy(tcfg, jax.device_get(self.jparams),
                                         device="cpu")
        self.jprefill = jax.jit(self.jm.prefill)
        self.jdecode = jax.jit(self.jm.decode_step)

    def prefill(self, tokens, jcache=None):
        """Both prefills of ``tokens (B, S)`` on the same cache (fresh
        when None); returns (jax logits, port logits, jax cache, port
        cache) as numpy."""
        B = tokens.shape[0]
        if jcache is None:
            jcache = self.jm.make_cache(B, SLOTS)
        tcache = cache_from_numpy(self.tcfg, jax.device_get(jcache),
                                  device="cpu")
        jl, jc = self.jprefill(self.jparams, {"tokens": jnp.asarray(tokens)},
                               jcache)
        tl, tc = self.tm.prefill(self.tparams,
                                 {"tokens": torch.from_numpy(tokens).long()},
                                 tcache)
        return np.asarray(jl, np.float32), _np(tl), jc, tc


@pytest.fixture(scope="module")
def smoke():
    return Pair(jconfigs.reduced(ARCH), configs.reduced(ARCH))


@pytest.fixture
def flash_calls(monkeypatch):
    """Counts the attention calls that take the flash route."""
    calls = []
    real = tattn.flash_attention

    def counted(q, k, v):
        calls.append(q.shape)
        return real(q, k, v)

    monkeypatch.setattr(tattn, "flash_attention", counted)
    return calls


def _tokens(B, S, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


# -- configs -----------------------------------------------------------------

def test_tinyllama_configs_match_the_jax_package():
    for name in ("full", "reduced"):
        got = getattr(configs, name)(ARCH)
        want = getattr(jconfigs, name)(ARCH)
        for f in ("name", "family", "n_layers", "d_model", "n_heads",
                  "n_kv_heads", "d_ff", "vocab", "dh", "qkv_bias",
                  "tie_embeddings", "rope_base", "norm", "mlp"):
            assert getattr(got, f) == getattr(want, f), (name, f)
        assert str(got.dtype).split(".")[-1] == jnp.dtype(want.dtype).name
    full = configs.full(ARCH)
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.d_ff, full.vocab, full.dtype) == (22, 2048, 32, 4, 5632,
                                                   32000, torch.bfloat16)


@pytest.mark.parametrize("arch", ["xlstm_350m"])
def test_unported_archs_raise(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        configs.full(arch)


@pytest.mark.parametrize("change", [{"family": "ssm"}])
def test_unported_families_and_options_raise(change):
    cfg = dataclasses.replace(configs.reduced(ARCH), **change)
    with pytest.raises(NotImplementedError,
                       match="ROADMAP queue 1, modules to port"):
        build_model(cfg, device="cpu")


@pytest.mark.parametrize("case", ["recurrentgemma_2b", "family-hybrid"])
def test_hybrid_arch_and_family_now_build(case):
    """The hybrid family is ported: its arch and the family on another
    config build, with the JAX package's segments."""
    if case == "recurrentgemma_2b":
        cfg, jcfg = configs.full(case), jconfigs.full(case)
    else:
        cfg = dataclasses.replace(configs.reduced(ARCH), family="hybrid")
        jcfg = dataclasses.replace(jconfigs.reduced(ARCH), family="hybrid")
    model = build_model(cfg, device="cpu")
    assert model.segs == jcfg.segments()
    assert model.segs[0][0] == ("rglru", "rglru", "attn_local")


# -- blocks ------------------------------------------------------------------

@pytest.mark.parametrize("name", ["rms_norm", "layer_norm", "swiglu",
                                  "gelu_mlp", "apply_rope"])
def test_blocks_match_jax(name):
    x = RNG.standard_normal((2, 5, 4, 16)).astype(np.float32)
    pos = RNG.integers(0, 4096, (2, 5)).astype(np.int32)
    w = [RNG.standard_normal(s).astype(np.float32)
         for s in ((16, 24), (16, 24), (24, 16), (24,), (16,))]
    args = {
        "rms_norm": (x, w[4]),
        "layer_norm": (x, w[4], w[4] * 0.5),
        "swiglu": (x, w[0], w[1], w[2]),
        "gelu_mlp": (x, w[0], w[3], w[2], w[4]),
        "apply_rope": (x, pos),
    }[name]
    want = getattr(jbl, name)(*(jnp.asarray(a) for a in args))
    got = getattr(tbl, name)(*(torch.from_numpy(a) for a in args))
    _close(got.numpy(), np.asarray(want))


def test_init_has_the_jax_package_tree_and_scales():
    """The port's random init has the JAX package's tree, shapes and
    scales (not its numbers: the generators differ)."""
    cfg = configs.reduced(ARCH)
    model = build_model(cfg, device="cpu")
    tp = model.init(torch.Generator().manual_seed(0))
    jp = jbuild(jconfigs.reduced(ARCH)).init(jax.random.PRNGKey(0))
    tshapes = jax.tree.map(lambda a: a.shape, _np(tp))
    jshapes = jax.tree.map(lambda a: a.shape, jax.device_get(jp))
    assert tshapes == jshapes
    assert cfg.num_params(tp) == sum(a.size for a in jax.tree.leaves(jp))
    wq = tp["segments"][0]["b0_dense"]["attn"]["wq"]
    assert abs(wq.std().item() * np.sqrt(cfg.d_model) - 1) < 0.1
    assert abs(tp["embed"].std().item() / 0.02 - 1) < 0.1
    with pytest.raises(ValueError, match="generator"):
        build_model(cfg, device="meta").init(torch.Generator())


def test_params_carried_across_keep_dtypes():
    cfg = dataclasses.replace(configs.reduced(ARCH), dtype=torch.bfloat16)
    jp = jax.device_get(jbuild(jconfigs.reduced(ARCH)).init(
        jax.random.PRNGKey(1)))
    tp = params_from_numpy(cfg, jp, device="cpu")
    blk = tp["segments"][0]["b0_dense"]
    assert tp["embed"].dtype == blk["attn"]["wq"].dtype == torch.bfloat16
    assert blk["ln1"]["scale"].dtype == tp["final_norm"]["scale"].dtype \
        == torch.float32
    np.testing.assert_array_equal(
        blk["mlp"]["wd"].float().numpy(),
        torch.tensor(jp["segments"][0]["b0_dense"]["mlp"]["wd"]).to(
            torch.bfloat16).float().numpy())


# -- the model ---------------------------------------------------------------

def test_forward_train_matches_jax(smoke, flash_calls):
    tokens = _tokens(2, 12, smoke.tcfg.vocab, 5)
    want, _ = smoke.jm.forward_train(smoke.jparams,
                                     {"tokens": jnp.asarray(tokens)})
    got, aux = smoke.tm.forward_train(
        smoke.tparams, {"tokens": torch.from_numpy(tokens).long()})
    _close(got.numpy(), np.asarray(want))
    assert float(aux) == 0.0
    assert len(flash_calls) == smoke.tcfg.n_layers


@pytest.mark.parametrize("S", [5, SLOTS])
def test_prefill_matches_jax_and_takes_the_kernel_route(smoke, flash_calls,
                                                        S):
    tokens = _tokens(1, S, smoke.tcfg.vocab, S)
    jl, tl, jc, tc = smoke.prefill(tokens)
    _close(tl, jl)
    for got, want in zip(jax.tree.leaves(_np(tc)),
                         jax.tree.leaves(_jnp_tree(jc))):
        _close(got, want)
    assert len(flash_calls) == smoke.tcfg.n_layers


def test_decode_steps_match_jax_on_the_plain_route(smoke, flash_calls):
    """Three decode steps of two lanes at mixed positions, from the same
    prefilled caches."""
    tokens = _tokens(2, 7, smoke.tcfg.vocab, 9)
    _, _, jc, tc = smoke.prefill(tokens)
    del flash_calls[:]
    pos = np.array([7, 3], np.int32)
    tok = _tokens(2, 1, smoke.tcfg.vocab, 10)
    for _ in range(3):
        jl, jc = smoke.jdecode(smoke.jparams, jc, jnp.asarray(tok),
                               jnp.asarray(pos))
        tl, tc = smoke.tm.decode_step(smoke.tparams, tc,
                                      torch.from_numpy(tok).long(),
                                      torch.from_numpy(pos).long())
        _close(tl.numpy(), np.asarray(jl))
        tok = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]
        pos = pos + 1
    for got, want in zip(jax.tree.leaves(_np(tc)),
                         jax.tree.leaves(_jnp_tree(jc))):
        _close(got, want)
    assert flash_calls == []


def test_prompt_longer_than_the_ring_takes_the_plain_route(smoke,
                                                           flash_calls):
    """S > W keeps only the last W entries, as the JAX model does."""
    tokens = _tokens(1, SLOTS + 5, smoke.tcfg.vocab, 12)
    jl, tl, jc, tc = smoke.prefill(tokens)
    _close(tl, jl)
    np.testing.assert_array_equal(_np(tc)[0]["b0_dense"]["pos"],
                                  np.asarray(jc[0]["b0_dense"]["pos"]))
    assert flash_calls == []


def test_stale_cache_prefill_takes_the_plain_route(smoke, flash_calls):
    """A prefill over a lane that still holds entries attends to them, as
    the JAX model does; the port checks freshness instead of assuming."""
    _, _, jc, _ = smoke.prefill(_tokens(1, 6, smoke.tcfg.vocab, 13))
    del flash_calls[:]
    jl, tl, _, _ = smoke.prefill(_tokens(1, 4, smoke.tcfg.vocab, 14), jc)
    _close(tl, jl)
    assert flash_calls == []


@pytest.mark.parametrize("change", [
    {"qkv_bias": True, "tie_embeddings": True},
    {"norm": "ln", "mlp": "gelu", "d_head": 8},
])
def test_model_options_match_jax(change):
    """qkv bias with tied embeddings (qwen2-style), LayerNorm + GELU with
    an explicit head dim: prefill then one decode step."""
    jcfg = dataclasses.replace(jconfigs.reduced(ARCH), **change)
    pair = Pair(jcfg, dataclasses.replace(configs.reduced(ARCH), **change),
                seed=4)
    # nonzero biases and norm offsets, norm scales other than 1
    jp = jax.tree.map(lambda a: a + 0.1 * np.sin(np.arange(a.size)).reshape(
        a.shape).astype(np.float32) if a.ndim <= 2 else a,
        jax.device_get(pair.jparams))
    pair.jparams = jax.tree.map(jnp.asarray, jp)
    pair.tparams = params_from_numpy(pair.tcfg, jp, device="cpu")
    jl, tl, jc, tc = pair.prefill(_tokens(1, 6, jcfg.vocab, 15))
    _close(tl, jl)
    tok = np.array([[3]], np.int32)
    pos = np.array([6], np.int32)
    jl, _ = pair.jdecode(pair.jparams, jc, jnp.asarray(tok),
                         jnp.asarray(pos))
    tl, _ = pair.tm.decode_step(pair.tparams, tc,
                                torch.from_numpy(tok).long(),
                                torch.from_numpy(pos).long())
    _close(tl.numpy(), np.asarray(jl))


def test_bfloat16_model_within_tolerance_of_jax():
    jcfg = dataclasses.replace(jconfigs.reduced(ARCH), dtype=jnp.bfloat16)
    pair = Pair(jcfg, dataclasses.replace(configs.reduced(ARCH),
                                          dtype=torch.bfloat16), seed=2)
    jl, tl, jc, tc = pair.prefill(_tokens(1, 11, jcfg.vocab, 16))
    tol = 3e-2 * np.abs(jl).max()
    np.testing.assert_allclose(tl, jl, rtol=0, atol=tol)
    tok, pos = np.array([[5]], np.int32), np.array([11], np.int32)
    jl, _ = pair.jdecode(pair.jparams, jc, jnp.asarray(tok), jnp.asarray(pos))
    tl, _ = pair.tm.decode_step(pair.tparams, tc,
                                torch.from_numpy(tok).long(),
                                torch.from_numpy(pos).long())
    np.testing.assert_allclose(tl.float().numpy(), np.asarray(jl, np.float32),
                               rtol=0, atol=3e-2 * np.abs(jl).max())


# -- the engine --------------------------------------------------------------

def _requests(cls):
    return [cls(i, np.asarray(p, np.int32), m)
            for i, (p, m) in enumerate(zip(PROMPTS, MAX_NEW))]


@pytest.fixture(scope="module")
def jax_served(smoke):
    """The JAX engine's (rid, tokens), in the order requests finished."""
    eng = JEngine(smoke.jm, smoke.jparams, lanes=2, slots=SLOTS)
    return [(r.rid, r.out) for r in eng.run(_requests(JRequest))]


def test_engine_serves_the_jax_engines_tokens(smoke, jax_served):
    batches = []
    eng = teng.ServeEngine(smoke.tm, smoke.tparams, lanes=2, slots=SLOTS,
                           event_sink=batches.append)
    done = eng.run(_requests(teng.Request))
    assert [(r.rid, r.out) for r in done] == jax_served
    assert [len(r.out) for r in sorted(done, key=lambda r: r.rid)] == MAX_NEW
    events = [e for b in batches for e in b]
    assert sorted(e.rid for e in events if e.kind == "acquire") \
        == sorted(e.rid for e in events if e.kind == "release") \
        == list(range(len(PROMPTS)))
    assert eng.idle and eng.events.pending == 0


def test_engine_temperature_sampling_matches_jax(smoke):
    """Sampling stays on the host with numpy: the same seed and the same
    logits draw the same tokens."""
    outs = []
    for eng_cls, req_cls, model, params in (
            (JEngine, JRequest, smoke.jm, smoke.jparams),
            (teng.ServeEngine, teng.Request, smoke.tm, smoke.tparams)):
        eng = eng_cls(model, params, lanes=2, slots=SLOTS, greedy=False,
                      temperature=0.8, seed=7)
        outs.append([r.out for r in eng.run(_requests(req_cls)[:3])])
    assert outs[0] == outs[1]


def test_lane_helpers_reset_and_adopt(smoke, jax_served):
    """A lane prefilled in one engine and adopted by another decodes as
    it would have in the first; reset clears only its lane."""
    a = teng.ServeEngine(smoke.tm, smoke.tparams, lanes=2, slots=SLOTS)
    b = teng.ServeEngine(smoke.tm, smoke.tparams, lanes=2, slots=SLOTS)
    req = _requests(teng.Request)[0]
    a.submit(req)
    lane_cache = [{k: {n: t.clone() for n, t in blk.items()}
                   for k, blk in seg.items()}
                  for seg in teng.lane_slice(a.cache, 0)]
    adopted = teng.Request(0, req.prompt, req.max_new, out=list(req.out))
    b.adopt_lane(1, lane_cache, adopted, pos=len(req.prompt),
                 last_tok=req.out[0])
    with pytest.raises(ValueError, match="busy"):
        b.adopt_lane(1, lane_cache, adopted, pos=0, last_tok=0)
    while not req.done:
        a.step()
    while not adopted.done:
        b.step()
    assert adopted.out == req.out == dict(jax_served)[0]
    blk = b.cache[0]["b0_dense"]
    other = {n: t[:, 0].clone() for n, t in blk.items()}
    assert bool((blk["pos"][:, 1] >= 0).any())
    teng.reset_lane(b.cache, 1)
    assert bool((blk["pos"][:, 1] == -1).all())
    assert not bool(blk["k"][:, 1].any()) and not bool(blk["v"][:, 1].any())
    for n, t in other.items():
        assert torch.equal(blk[n][:, 0], t)


def test_moe_engine_serves_the_jax_engines_tokens(monkeypatch):
    """dbrx-smoke on 4 lanes: every decode step routes all 4 lanes'
    tokens (idle lanes too, fed what the JAX engine feeds them) at a
    capacity of ``int(4 * 4 * 1.25 / 8) = 2`` pairs an expert, so steps
    drop pairs; the tokens must be the JAX engine's all the same."""
    from repro_torch.models import moe as tmoe

    moe = Pair(jconfigs.reduced("dbrx-132b"), configs.reduced("dbrx-132b"))
    jdone = JEngine(moe.jm, moe.jparams, lanes=4, slots=SLOTS).run(
        _requests(JRequest))
    drops = []
    real = tmoe.moe_ffn

    def counted(p, x, dims):
        B, S, d = x.shape
        if S == 1:
            cap = max(1, int(B * dims.top_k * dims.capacity_factor
                             / dims.n_experts))
            _, experts, _ = tmoe._route(p["router"], x.reshape(B, d), dims)
            per = torch.bincount(experts.reshape(-1),
                                 minlength=dims.n_experts)
            drops.append(int((per - cap).clamp(min=0).sum()))
        return real(p, x, dims)

    monkeypatch.setattr(tmoe, "moe_ffn", counted)
    done = teng.ServeEngine(moe.tm, moe.tparams, lanes=4, slots=SLOTS).run(
        _requests(teng.Request))
    assert [(r.rid, r.out) for r in done] == [(r.rid, r.out) for r in jdone]
    assert max(drops) > 0, drops


def test_launch_serve_on_the_cpu(capsys):
    from repro_torch.launch import serve

    assert serve.main(["--reduced", "--device", "cpu", "--requests", "3",
                       "--max-new", "4", "--slots", "16"]) == 0
    out = capsys.readouterr().out
    assert out.count("req ") == 3 and "tokens in" in out and "CPU" in out
    assert "[serve] qwen2-smoke:" in out      # the JAX launcher's default
    assert serve.main(["--arch", "dbrx-132b", "--reduced", "--device", "cpu",
                       "--requests", "2", "--max-new", "3",
                       "--slots", "16"]) == 0
    assert "[serve] dbrx-smoke: 2 requests" in capsys.readouterr().out
