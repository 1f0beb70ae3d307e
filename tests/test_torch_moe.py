"""The port's MoE family (``repro_torch.models.moe``, the ``moe`` family of
``models.model``, ``configs.dbrx_132b``) against the JAX package's, on
the CPU.

In process, JAX on one device, weights drawn by the JAX package and
carried across with ``params_from_numpy``:

* ``_route`` (a tied-logit case included: equal probabilities go to the
  lower expert first, as ``lax.top_k`` orders them) and ``moe_ffn`` at
  the default capacity factor (pairs dropped; asserted) and with a
  shared expert: gates, experts, outputs and the aux loss within rtol =
  atol = 1e-5;
* dbrx-smoke and a ``first_k_dense = 1`` variant: the configs, the
  weight tree, one prefill and decode step, ``forward_train``'s logits
  and aux and ``Model.loss`` within 1e-5, its gradients within 1e-4 of
  each leaf's largest |gradient| (``tests/test_torch_models.py``'s
  rule).

The expert-parallel island against the JAX package's mesh ``("data",
"model") = (2, 4)`` model, in one 8-device subprocess (``python
tests/test_torch_moe.py OUT.npz``): the ``moe-dispatch`` entry's model
(2 MoE layers, d 64, 8 experts top-2, one shared expert) with each
dispatch (``psum``, ``rs``, ``a2a``) at capacity factors 16 and 1.25;
the port runs it over 4 kernels x 2 data groups (``ExpertMesh``): logits
and aux within 1e-5, and every layer's exchanges and collective calls
as the dispatch's table says.  The gradient: ``Model.loss`` (aux weight
0.01) and every gradient leaf against the mesh model's ``jax.grad``
within 1e-5, the backward's exchanges and collective calls by the
counting rule of ``repro_torch.models.moe``, and one ``xla`` trainer
step's parameters against the JAX ``Trainer``'s within 1e-4
(``tests/md_checks.py``'s bound).  The subprocess also compiles the
JAX island's own gradient program for each dispatch and reports its
collectives by kind, which the rule is held to.  An a2a island at 512
experts in bfloat16 carries expert ids past 256 through the meta lane.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_reference import run_reference  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.core.state import ShoalContext  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.convert import (cache_from_numpy,  # noqa: E402
                                        params_from_numpy)
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.training import Trainer  # noqa: E402
from repro_torch.tree import tree_map, tree_paths  # noqa: E402

TOL = 1e-5
SLOTS = 16
K, DATA = 4, 2                    # the island: kernels x data groups
DISPATCHES = ("psum", "rs", "a2a")
FACTORS = (16.0, 1.25)
ARCH = "dbrx-132b"


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=tol,
                               atol=tol)


def _t(a):
    return torch.from_numpy(np.array(a))


def _dims(**kw):
    import jax.numpy as jnp  # noqa: F401  (JAX up before its MoEDims)
    from repro.models.moe import MoEDims as JDims

    return JDims(**kw), tmoe.MoEDims(**kw)


def _jax_moe(dims, d, seed):
    """JAX ``init_moe`` weights as numpy, and the port's copy."""
    import jax

    from repro.models.moe import init_moe

    tree = jax.device_get(init_moe(jax.random.PRNGKey(seed), d, dims))
    return tree, {k: _t(v) for k, v in tree.items()}


def _dropped(experts, E: int, capacity: int) -> int:
    """Pairs over their expert's capacity."""
    counts = np.bincount(np.asarray(experts).reshape(-1), minlength=E)
    return int(np.clip(counts - capacity, 0, None).sum())


# -- routing and the single-device dispatch ----------------------------------

def test_route_matches_jax_with_ties():
    import jax.numpy as jnp

    from repro.models.moe import _route as jroute

    jd, td = _dims(n_experts=8, top_k=3, d_ff_expert=16)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((40, 24)).astype(np.float32)
    w = rng.standard_normal((24, 8)).astype(np.float32)
    w[:, 5] = w[:, 2]              # experts 2 and 5 tie on every token,
    w[:, 7] = w[:, 1]              # and 1 and 7
    jg, je, ja = jroute(jnp.asarray(w), jnp.asarray(x), jd)
    tg, te, ta = tmoe._route(_t(w), _t(x), td)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    _close(tg, jg)
    _close(ta, ja)
    ties = (np.asarray(je)[:, :, None] == np.array([2, 5, 1, 7])).any(1)
    assert ties[:, [0, 1]].all(1).any() or ties[:, [2, 3]].all(1).any()
    for a, b in ((2, 5), (1, 7)):  # both picked: the lower index first
        e = te.numpy()
        both = (e == a).any(1) & (e == b).any(1)
        assert (np.argmax(e[both] == a, 1) < np.argmax(e[both] == b, 1)).all()


@pytest.mark.parametrize("n_shared", [0, 1])
def test_moe_ffn_matches_jax_with_drops(n_shared):
    import jax.numpy as jnp

    from repro.models.moe import _route as jroute
    from repro.models.moe import moe_ffn as jffn

    jd, td = _dims(n_experts=8, top_k=2, d_ff_expert=48, n_shared=n_shared)
    tree, tp = _jax_moe(jd, 32, seed=n_shared)
    x = np.random.default_rng(1).standard_normal((2, 16, 32)).astype(
        np.float32)
    jout, jaux = jffn(tree, jnp.asarray(x), jd)
    tout, taux = tmoe.moe_ffn(tp, _t(x), td)
    _close(tout, jout)
    _close(taux, jaux)
    capacity = int(32 * 2 * 1.25 / 8)
    _, experts, _ = jroute(tree["router"], jnp.asarray(x.reshape(32, 32)), jd)
    assert _dropped(experts, 8, capacity) > 0


def test_init_moe_tree_and_scales():
    """The port's expert stacks have the JAX package's shapes and
    fan-in scales (``in_axis=1`` of ``(E, d, fe)``, shifted by the
    layer axis), drawn in ``dtype``."""
    jd, td = _dims(n_experts=4, top_k=2, d_ff_expert=256, n_shared=2)
    tree, _ = _jax_moe(jd, 64, seed=0)
    own = tmoe.init_moe(torch.Generator().manual_seed(0), 64, td, lead=(3,),
                        dtype=torch.bfloat16)
    assert sorted(own) == sorted(tree)
    for k, v in tree.items():
        assert own[k].shape == (3,) + v.shape and own[k].dtype == \
            torch.bfloat16, k
        got = own[k].float().std().item()
        assert abs(got / v.std() - 1) < 0.1, (k, got, v.std())


# -- the dbrx family ---------------------------------------------------------

FIRST_DENSE = "dbrx-smoke-first-dense"


def _cfgs(name):
    from repro import configs as jconfigs

    j, t = jconfigs.reduced(ARCH), configs.reduced(ARCH)
    if name == FIRST_DENSE:
        j = dataclasses.replace(j, n_layers=3, first_k_dense=1)
        t = dataclasses.replace(t, n_layers=3, first_k_dense=1)
    return j, t


_PAIRS = {}


def pair(name):
    """(jax model, jax params, port model, port params) of ``name``."""
    if name not in _PAIRS:
        import jax

        from repro.models.model import build_model as jbuild

        jcfg, tcfg = _cfgs(name)
        jm = jbuild(jcfg)
        jparams = jm.init(jax.random.PRNGKey(0))
        tm = build_model(tcfg, device="cpu")
        _PAIRS[name] = (jm, jparams, tm, params_from_numpy(
            tcfg, jax.device_get(jparams), device="cpu"))
    return _PAIRS[name]


def test_dbrx_configs_match_the_jax_package():
    import jax.numpy as jnp

    from repro import configs as jconfigs

    for name in ("full", "reduced"):
        got = getattr(configs, name)(ARCH)
        want = getattr(jconfigs, name)(ARCH)
        for f in ("name", "family", "n_layers", "d_model", "n_heads",
                  "n_kv_heads", "d_ff", "vocab", "dh", "qkv_bias",
                  "tie_embeddings", "rope_base", "norm", "mlp", "frontend",
                  "first_k_dense", "aux_loss_weight", "mla"):
            assert getattr(got, f) == getattr(want, f), (name, f)
        assert dataclasses.asdict(got.moe) == dataclasses.asdict(want.moe)
        assert str(got.dtype).split(".")[-1] == jnp.dtype(want.dtype).name
        assert got.segments() == want.segments()
    full = configs.full(ARCH)
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.dh, full.vocab, full.moe.n_experts, full.moe.top_k,
            full.moe.d_ff_expert, full.dtype) == (
        40, 6144, 48, 8, 128, 100352, 16, 4, 10752, torch.bfloat16)
    _, tcfg = _cfgs(FIRST_DENSE)
    assert tcfg.segments() == [(("dense",), 1), (("moe",), 2)]


@pytest.mark.parametrize("name", ["dbrx-smoke", FIRST_DENSE])
def test_weight_tree_carries_across(name):
    """The port's init has the JAX tree (the MoE leaves included) and
    ``params_from_numpy`` carries every leaf, the router held in
    ``cfg.dtype`` as the JAX package casts it at every use."""
    import jax

    from test_torch_train import jax_arrays, port_arrays

    _, jparams, tm, tparams = pair(name)
    own = tm.init(torch.Generator().manual_seed(0))
    shapes = {p: tuple(t.shape) for p, t in tree_paths(own)}
    want = jax_arrays(jparams)
    got = port_arrays(tparams)
    assert list(shapes) == list(want) == list(got)
    for p, a in want.items():
        assert shapes[p] == a.shape, p
        np.testing.assert_array_equal(got[p], a, err_msg=p)
    assert any(p.endswith("moe/router") for p in shapes)
    bf16 = dataclasses.replace(tm.cfg, dtype=torch.bfloat16)
    carried = params_from_numpy(bf16, jax.device_get(jparams), device="cpu")
    seg = carried["segments"][-1]["b0_moe"]
    assert seg["moe"]["router"].dtype == torch.bfloat16
    assert seg["ln2"]["scale"].dtype == torch.float32


@pytest.mark.parametrize("name", ["dbrx-smoke", FIRST_DENSE])
def test_logits_and_loss_match_jax(name):
    import jax
    import jax.numpy as jnp

    jm, jparams, tm, tparams = pair(name)
    toks = np.random.default_rng(5).integers(0, 512, (2, 12)).astype(
        np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    jl, ja = jax.jit(jm.forward_train)(jparams, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        tl, ta = tm.forward_train(tparams, {"tokens": _t(toks).long()})
    _close(tl, jl)
    _close(ta, ja)
    assert float(ta) > 0
    jloss = jax.jit(jm.loss)(jparams, {k: jnp.asarray(v)
                                       for k, v in batch.items()})
    with torch.no_grad():
        tloss = tm.loss(tparams, {k: _t(v).long() for k, v in batch.items()})
    _close(tloss, jloss)


@pytest.mark.parametrize("name", ["dbrx-smoke", FIRST_DENSE])
def test_gradients_match_jax(name):
    import jax
    import jax.numpy as jnp

    from test_torch_train import jax_arrays, port_arrays

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
    routers = [p for p in want if p.endswith("moe/router")]
    assert routers and all(np.abs(want[p]).max() > 0 for p in routers)


@pytest.mark.parametrize("name", ["dbrx-smoke", FIRST_DENSE])
def test_prefill_and_decode_match_jax(name):
    import jax
    import jax.numpy as jnp

    jm, jparams, tm, tparams = pair(name)
    toks = np.random.default_rng(7).integers(0, 512, (2, 9)).astype(np.int32)
    jcache = jm.make_cache(2, SLOTS)
    tcache = cache_from_numpy(tm.cfg, jax.device_get(jcache), device="cpu")
    jl, jc = jax.jit(jm.prefill)(jparams, {"tokens": jnp.asarray(toks)},
                                 jcache)
    tl, tc = tm.prefill(tparams, {"tokens": _t(toks).long()}, tcache)
    _close(tl, jl)
    step = np.array([[3], [400]], np.int32)
    pos = np.array([9, 6], np.int32)
    jl, _ = jax.jit(jm.decode_step)(jparams, jc, jnp.asarray(step),
                                    jnp.asarray(pos))
    tl, _ = tm.decode_step(tparams, tc, _t(step).long(), _t(pos).long())
    _close(tl, jl)


def test_moe_family_needs_its_dims():
    cfg = dataclasses.replace(configs.reduced(ARCH), moe=None)
    with pytest.raises(ValueError, match="needs cfg.moe"):
        build_model(cfg, device="cpu")


# -- the expert-parallel island ----------------------------------------------

def _island_cfg(dispatch, cf, dtype=torch.float32):
    from repro_torch.models.model import ModelConfig

    dims = tmoe.MoEDims(n_experts=8, top_k=2, d_ff_expert=64, n_shared=1,
                        capacity_factor=cf, dispatch=dispatch)
    return ModelConfig(name="tm", family="moe", n_layers=2, d_model=64,
                       n_heads=4, n_kv_heads=4, d_ff=128, vocab=128,
                       moe=dims, dtype=dtype)


def _island_tokens():
    return np.random.default_rng(0).integers(0, 128, (4, 32)).astype(
        np.int32)


def _island_batch():
    toks = _island_tokens()
    return {"tokens": toks, "labels": np.roll(toks, -1, 1)}


def _island_grad_ops(mesh, base, out):
    """Collectives by kind in the JAX island's compiled gradient program,
    per dispatch: ``d/d(p, h) [(out * w).sum() + aux]`` of one island
    call on ``(4, 32, 64)`` tokens."""
    import jax
    import jax.numpy as jnp

    from repro.launch.hlo_analysis import parse_collectives
    from repro.models.model import build_model as jbuild
    from repro.models.moe import init_moe

    p = init_moe(jax.random.PRNGKey(0), base.d_model, base.moe)
    p = {k: p[k] for k in ("router", "wg", "wu", "wd")}
    rng = np.random.default_rng(1)
    h, w = (jnp.asarray(rng.standard_normal((4, 32, base.d_model)).astype(
        np.float32)) for _ in range(2))
    for dispatch in DISPATCHES:
        cfg = dataclasses.replace(base, moe=dataclasses.replace(
            base.moe, dispatch=dispatch))
        run = jbuild(cfg, mesh=mesh, dp_axes=("data",))._ep_ctx()

        def f(p, h):
            o, aux = run(p, h)
            return (o * w).sum() + aux

        hlo = jax.jit(jax.grad(f, argnums=(0, 1))).lower(p, h).compile()
        for kind, n in parse_collectives(hlo.as_text()).ops.items():
            out[f"{dispatch}/island_grad_ops/{kind}"] = np.asarray(n)


def _run_reference(out_path):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro.launch.hlo_analysis import parse_collectives
    from repro.models.model import ModelConfig as JConfig
    from repro.models.model import build_model as jbuild
    from repro.models.moe import MoEDims as JDims
    from repro.optim import adamw as jaw
    from repro.runtime.jax_compat import make_mesh
    from repro.training.train import Trainer as JTrainer
    from repro.training.train import TrainerConfig as JTrainerConfig
    from repro.training.train import TrainState as JState

    mesh = make_mesh((DATA, K), ("data", "model"))
    toks = jnp.asarray(_island_tokens())
    batch = {k: jax.device_put(jnp.asarray(v),
                               NamedSharding(mesh, P(("data",))))
             for k, v in _island_batch().items()}
    out = {}
    for cf in FACTORS:
        base = JConfig(name="tm", family="moe", n_layers=2, d_model=64,
                       n_heads=4, n_kv_heads=4, d_ff=128, vocab=128,
                       moe=JDims(n_experts=8, top_k=2, d_ff_expert=64,
                                 n_shared=1, capacity_factor=cf),
                       dtype=jnp.float32)
        params = jbuild(base).init(jax.random.PRNGKey(1))
        if cf == FACTORS[0]:
            for i, leaf in enumerate(jax.tree.leaves(
                    jax.device_get(params))):
                out[f"params/{i}"] = np.asarray(leaf)
        for dispatch in DISPATCHES:
            cfg = dataclasses.replace(base, moe=dataclasses.replace(
                base.moe, dispatch=dispatch))
            m = jbuild(cfg, mesh=mesh, dp_axes=("data",))
            logits, aux = jax.jit(m.forward_train)(params, {"tokens": toks})
            out[f"{dispatch}/{cf}/logits"] = np.asarray(logits)
            out[f"{dispatch}/{cf}/aux"] = np.asarray(aux)
            key = f"{dispatch}/{cf}"
            out[f"{key}/loss"] = np.asarray(jax.jit(m.loss)(params, batch))
            grad = jax.jit(jax.grad(m.loss)).lower(params, batch).compile()
            for i, leaf in enumerate(jax.tree.leaves(jax.device_get(
                    grad(params, batch)))):
                out[f"{key}/grad/{i}"] = np.asarray(leaf)
            for kind, n in parse_collectives(grad.as_text()).ops.items():
                out[f"{key}/grad_ops/{kind}"] = np.asarray(n)
            tr = JTrainer(m, jaw.AdamWConfig(lr=1e-3),
                          JTrainerConfig(donate=False))
            st = JState(params=params, opt_state=jaw.adamw_init(params),
                        step=jnp.zeros((), jnp.int32))
            st, _ = tr.make_train_step()(st, batch)
            for i, leaf in enumerate(jax.tree.leaves(jax.device_get(
                    st.params))):
                out[f"{key}/step/{i}"] = np.asarray(leaf)
        if cf == FACTORS[0]:
            _island_grad_ops(mesh, base, out)
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("moe") / "reference.npz"
    return run_reference(__file__, path, timeout=600)


def _island_params(reference, cfg):
    from repro_torch.tree import tree_unflatten

    like = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    n = sum(1 for k in reference if k.startswith("params/"))
    return params_from_numpy(cfg, tree_unflatten(
        like, [reference[f"params/{i}"] for i in range(n)]), device="cpu")


def _per_layer(dispatch):
    """(exchanges, collective calls) of one MoE layer on K kernels: the
    dispatch's collectives and the aux's all-reduce."""
    ar = 2 * (K - 1)
    return {"psum": (ar + ar, {"all_reduce": 2}),
            "rs": ((K - 1) + (K - 1) + ar,
                   {"all_gather": 1, "reduce_scatter": 1, "all_reduce": 1}),
            "a2a": (1 + 1 + ar, {"all_to_all": 2, "all_reduce": 1})}[dispatch]


@pytest.mark.parametrize("cf", FACTORS)
@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_island_matches_the_jax_mesh(reference, dispatch, cf):
    from repro_torch.core.state import COLLECTIVE_KINDS

    cfg = _island_cfg(dispatch, cf)
    params = _island_params(reference, cfg)
    ctx = ShoalContext(K, device="cpu")
    model = build_model(cfg, device="cpu",
                        ep=tmoe.ExpertMesh(ctx, data=DATA))
    toks = {"tokens": _t(_island_tokens()).long()}
    with torch.no_grad():
        logits, aux = model.forward_train(params, toks)
        oracle, oaux = build_model(cfg, device="cpu").forward_train(
            params, toks)
    _close(logits, reference[f"{dispatch}/{cf}/logits"])
    _close(aux, reference[f"{dispatch}/{cf}/aux"])
    ex, calls = _per_layer(dispatch)
    assert ctx.exchanges == cfg.n_layers * ex
    assert ctx.collectives == {k: cfg.n_layers * calls.get(k, 0)
                               for k in COLLECTIVE_KINDS}
    if cf == FACTORS[0]:       # no drops: every dispatch is the oracle's
        _close(logits, oracle.numpy(), 1e-4)
    else:                      # the shards' capacities drop pairs
        assert not np.allclose(logits.numpy(),
                               reference[f"{dispatch}/{FACTORS[0]}/logits"],
                               atol=1e-3)


def test_island_falls_back_where_the_jax_package_does():
    """One kernel, or experts that do not split over the kernels: the
    single-device ``moe_ffn`` (no collective)."""
    cfg = _island_cfg("a2a", 16.0)
    for ctx in (ShoalContext(1, device="cpu"), ShoalContext(3, device="cpu")):
        model = build_model(cfg, device="cpu", ep=tmoe.ExpertMesh(ctx))
        assert model._island is None
    assert build_model(cfg, device="cpu", ep=tmoe.ExpertMesh(
        ShoalContext(K, device="cpu")))._island is not None


def _backward_per_layer(dispatch):
    """(exchanges, collective calls) of one MoE layer's backward on K
    kernels: the adjoint of each forward collective (the aux's
    all-reduce included, ``Model.loss`` weighs it in), one all-reduce
    for the psum dispatch's replicated tokens and one for the router."""
    ar = 2 * (K - 1)
    return {"psum": (4 * ar, {"all_reduce": 4}),
            "rs": (2 * (K - 1) + 2 * ar,
                   {"all_gather": 1, "reduce_scatter": 1, "all_reduce": 2}),
            "a2a": (2 + 2 * ar, {"all_to_all": 2, "all_reduce": 2})}[dispatch]


def _island_run(reference, dispatch, cf):
    """(model, params, ctx, batch) of the port's mesh model."""
    cfg = _island_cfg(dispatch, cf)
    params = _island_params(reference, cfg)
    ctx = ShoalContext(K, device="cpu")
    model = build_model(cfg, device="cpu",
                        ep=tmoe.ExpertMesh(ctx, data=DATA))
    batch = {k: _t(v).long() for k, v in _island_batch().items()}
    return model, params, ctx, batch


def _leaves(reference, prefix):
    n = sum(1 for k in reference if k.startswith(prefix))
    return [reference[f"{prefix}{i}"] for i in range(n)]


@pytest.mark.parametrize("cf", FACTORS)
@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_island_gradients_match_the_jax_mesh(reference, dispatch, cf):
    """``Model.loss`` and every gradient leaf of the mesh model against
    its ``jax.grad`` within 1e-5; the backward counts as the rule
    says, on top of the forward."""
    from repro_torch.core.state import COLLECTIVE_KINDS
    from repro_torch.tree import tree_leaves

    model, params, ctx, batch = _island_run(reference, dispatch, cf)
    loss, grads = Trainer(model, AdamWConfig(lr=1e-3)).value_and_grad(
        params, batch)
    _close(loss, reference[f"{dispatch}/{cf}/loss"])
    want = _leaves(reference, f"{dispatch}/{cf}/grad/")
    got = tree_leaves(grads)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w)
    routed = [g for g, (path, _) in zip(got, tree_paths(grads))
              if path.rsplit("/", 1)[-1] in tmoe.ROUTED]
    assert len(routed) == 4 and all(g.abs().max() > 0 for g in routed)
    (fx, fc), (bx, bc) = _per_layer(dispatch), _backward_per_layer(dispatch)
    L = model.cfg.n_layers
    assert ctx.exchanges == L * (fx + bx)
    assert ctx.collectives == {k: L * (fc.get(k, 0) + bc.get(k, 0))
                               for k in COLLECTIVE_KINDS}


@pytest.mark.parametrize("cf", FACTORS)
@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_island_trainer_step_matches_jax(reference, dispatch, cf):
    """One ``xla`` step of the mesh model: every parameter within 1e-4
    of the JAX ``Trainer``'s (``tests/md_checks.py``'s bound), the
    update written in place under ``donate`` with the same numbers."""
    from repro_torch.training import TrainerConfig
    from repro_torch.tree import tree_leaves

    model, params, ctx, batch = _island_run(reference, dispatch, cf)
    want = _leaves(reference, f"{dispatch}/{cf}/step/")
    tr = Trainer(model, AdamWConfig(lr=1e-3))
    new, metrics = tr.step(tr.state_for(params), batch)
    got = tree_leaves(new.params)
    assert len(got) == len(want) and bool(torch.isfinite(metrics["loss"]))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4)
    donor = Trainer(model, AdamWConfig(lr=1e-3), TrainerConfig(donate=True))
    state = donor.state_for(tree_map(torch.clone, params))
    kept = tree_leaves(state.params)
    same, _ = donor.step(state, batch)
    for a, b, c in zip(tree_leaves(same.params), got, kept):
        assert torch.equal(a, b) and a is c


def test_island_refuses_grad():
    """The island used to refuse inputs that require grad; it now takes
    them.  Under grad mode ``Model.loss`` is bitwise the ``no_grad``
    loss, and the no-grad call counts the forward's collectives only
    (no autograd edge is built there); ``backward`` reaches every routed
    leaf through the counted adjoints."""
    from repro_torch.tree import tree_leaves

    cfg = _island_cfg("psum", 16.0)
    ctx = ShoalContext(K, device="cpu")
    model = build_model(cfg, device="cpu",
                        ep=tmoe.ExpertMesh(ctx, data=DATA))
    params = model.init(torch.Generator().manual_seed(0))
    toks = _t(_island_tokens()).long()
    batch = {"tokens": toks, "labels": toks}
    with torch.no_grad():
        plain = model.loss(params, batch)
    fx, _ = _per_layer("psum")
    assert ctx.exchanges == cfg.n_layers * fx
    ctx.exchanges = 0
    for leaf in tree_leaves(params):
        leaf.requires_grad_()
    leaves = params["segments"][0]["b0_moe"]["moe"]
    loss = model.loss(params, batch)
    assert torch.equal(loss.detach(), plain)
    loss.backward()
    bx, _ = _backward_per_layer("psum")
    assert ctx.exchanges == cfg.n_layers * (fx + bx)
    for name in tmoe.ROUTED:
        g = leaves[name].grad
        assert g is not None and g.shape == leaves[name].shape
        assert bool(torch.isfinite(g).all()) and g.abs().max() > 0


@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_backward_rule_against_the_jax_island_gradient(reference, dispatch):
    """The JAX island's compiled gradient program (``d/d(p, h)
    [(out * w).sum() + aux]``) holds the port's backward collectives by
    kind, plus what the port does without a collective or does not
    repeat: one all-reduce of the expert slabs' cotangents over the
    ``data`` axis (a local sum over the port's data groups) and the
    forward collectives whose results the backward reads (rs: the token
    all-gather; a2a: both all-to-alls; the port keeps them from its
    forward pass)."""
    _, calls = _backward_per_layer(dispatch)
    extra = {"psum": {"all_reduce": 1},
             "rs": {"all_reduce": 1, "all_gather": 1},
             "a2a": {"all_reduce": 1, "all_to_all": 2}}[dispatch]
    hlo_kind = {"all_reduce": "all-reduce", "all_gather": "all-gather",
                "reduce_scatter": "reduce-scatter",
                "all_to_all": "all-to-all"}
    prefix = f"{dispatch}/island_grad_ops/"
    got = {k[len(prefix):]: int(v) for k, v in reference.items()
           if k.startswith(prefix)}
    assert got == {hlo_kind[k]: calls.get(k, 0) + extra.get(k, 0)
                   for k in hlo_kind if calls.get(k, 0) + extra.get(k, 0)}


def test_shoal_backend_refuses_an_expert_parallel_model():
    """The JAX package's shoal step fails on a mesh MoE model (its
    shard_map over the data axis meets the island's); the port refuses
    it when the trainer is built, and trains it with the xla backend."""
    from repro_torch.training import TrainerConfig

    cfg = _island_cfg("psum", 16.0)
    model = build_model(cfg, device="cpu", ep=tmoe.ExpertMesh(
        ShoalContext(K, device="cpu"), data=DATA))
    with pytest.raises(ValueError, match="expert-parallel"):
        Trainer(model, AdamWConfig(lr=1e-3),
                TrainerConfig(comm_backend="shoal"), kernels=2)
    Trainer(model, AdamWConfig(lr=1e-3))
    Trainer(build_model(cfg, device="cpu"), AdamWConfig(lr=1e-3),
            TrainerConfig(comm_backend="shoal"), kernels=2)


def test_island_rejects_shapes_that_do_not_shard():
    dims = tmoe.MoEDims(n_experts=8, top_k=2, d_ff_expert=8, dispatch="rs")
    p = tmoe.init_moe(torch.Generator().manual_seed(0), 8, dims)
    mesh = tmoe.ExpertMesh(ShoalContext(K, device="cpu"), data=2)
    with pytest.raises(ValueError, match="does not shard"):
        tmoe.moe_routed_island(p, torch.zeros(2, 6, 8), dims, mesh,
                               torch.float32)
    with pytest.raises(ValueError, match="does not shard"):
        tmoe.moe_routed_island(p, torch.zeros(3, 8, 8), dims, mesh,
                               torch.float32)


def test_meta_lane_carries_expert_ids_past_256_in_bfloat16():
    """512 experts over 4 kernels, bfloat16: the a2a island's expert ids
    ride in an int16 lane bitcast into bfloat16 (a value cast would
    round id 257 to 256); with capacity for every pair the island is
    ``moe_ffn`` on the same weights, within bfloat16's rounding."""
    from repro_torch.actors.coalesce import pack_meta_lane, unpack_meta_lane

    ids = torch.arange(1, 513, dtype=torch.int32)
    lane = pack_meta_lane(ids, torch.bfloat16)
    assert lane.dtype == torch.bfloat16
    assert torch.equal(unpack_meta_lane(lane.clone()), ids)
    assert not torch.equal(ids.to(torch.bfloat16).to(torch.int32), ids)

    E = 512
    dims = tmoe.MoEDims(n_experts=E, top_k=2, d_ff_expert=8,
                        capacity_factor=float(E), dispatch="a2a")
    gen = torch.Generator().manual_seed(3)
    p = tmoe.init_moe(gen, 16, dims, dtype=torch.bfloat16)
    h = torch.randn(2, 32, 16, generator=gen).to(torch.bfloat16)
    ctx = ShoalContext(K, device="cpu")
    got, aux = tmoe.moe_routed_island(p, h, dims, tmoe.ExpertMesh(ctx),
                                      torch.bfloat16)
    want, _ = tmoe.moe_ffn(p, h, dims)
    _, experts, _ = tmoe._route(p["router"], h.reshape(64, 16), dims)
    assert int(experts.max()) > 256
    top = want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= 2e-2 * top
    assert ctx.collectives["all_to_all"] == 2


if __name__ == "__main__":
    _run_reference(sys.argv[1])
