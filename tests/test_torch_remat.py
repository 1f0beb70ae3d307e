"""Activation checkpointing (``ModelConfig.remat``: none / full / dots)
against the JAX package, on the CPU.

* Every config carries the JAX package's ``remat`` (``"dots"`` in all
  ten ``full()`` configs, ``"none"`` in every ``reduced()`` one), and an
  unknown policy raises at ``Model`` construction.
* At the smoke config of the dense, audio, MoE, vlm, hybrid and ssm
  families (float32, the JAX init's weights carried across, the vlm's
  cross gates opened): the port's loss and gradients are bitwise equal
  under the three policies, and within 1e-5 of the JAX package's
  ``jax.value_and_grad(Model.loss)`` under the same policy (rtol = 1e-5
  and atol = 1e-5, of the loss, and of each gradient leaf's largest
  |value|; the xLSTM's gradients within 1e-4, ``GRAD_TOL``).  Under
  ``full`` and ``dots`` every superblock runs as one checkpoint region.
  The recomputation reruns the associative scan's in-place ``copy_`` writes
  (``recurrent._interleave``) and the xLSTM's, and the bitwise equality
  holds through them.
* What a superblock keeps for the backward, distinct storages, the
  parameters left out: under ``none`` everything autograd saves (an
  outer ``saved_tensors_hooks``); under ``full`` and ``dots`` the
  region's saved input (``torch.utils.checkpoint`` saves its tensor
  arguments through the hooks that are active around the region), and
  under ``dots`` also the outputs the policy caches (the port's
  ``dots_policy`` wrapped to record them).  The bytes fall none > dots
  > full, ``full`` keeps exactly the superblock's input ``x``, and the
  shapes ``dots`` keeps are the JAX superblock's scan residuals that
  ``saved_residuals`` reports (parameters and closed-over constants --
  positions, rope frequencies, image features -- left out), in every
  family: the superblock's last batch-free product, whose output only
  the residual add that ends the region reads, runs as
  ``blocks.product(..., unread=True)`` and is not kept, as JAX's
  partial evaluation drops it (a MoE superblock ends with its experts,
  a batched product that is recomputed).
* The expert-parallel island (psum / rs / a2a over 4 kernels x 2 data
  groups) and ring attention under ``seq_shard``: exchanges, collective
  calls and ring-kernel calls of one ``value_and_grad``, asserted
  exactly under ``none`` and ``dots``.  The rule: non-reentrant
  checkpointing recomputes a region's forward from its start and stops
  at the last operation that saved a tensor for the backward, so a
  forward collective before that point runs once more a region.  With
  shared experts (which run after the island and save) that is every
  island collective; without them psum recomputes none (its two
  all-reduces come after the last save), rs its all-gather, a2a both
  all-to-alls.  Ring attention's 3 n exchanges a layer all come before
  the output projection, so all run again; its backward adds the k and
  v hand-backs, 2 (n - 1) a layer, under every policy.
* Beside those counts, the JAX mesh (2, 4)'s compiled gradient program
  under each policy (one 8-device subprocess, ``python
  tests/test_torch_remat.py OUT.npz``, started when the module's first
  test runs and read by the last), recorded: GSPMD's tensor-parallel
  collectives make the rest, so only that remat never removes a
  collective is asserted, and that the ring's collective-permutes are
  the port's exchanges under each policy.  ``scripts/remat_counts.py``
  prints both tables.
"""

import dataclasses
import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from repro_torch import configs  # noqa: E402
from repro_torch.core import collectives as coll  # noqa: E402
from repro_torch.core.state import ShoalContext  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.training import Trainer  # noqa: E402
from repro_torch.tree import tree_leaves, tree_paths  # noqa: E402

ARCHS = [i.replace("_", "-") for i in configs.ARCH_IDS]
FAMILIES = ["tinyllama-1.1b", "musicgen-medium", "dbrx-132b",
            "llama-3.2-vision-90b", "recurrentgemma-2b", "xlstm-350m"]
POLICIES = ("none", "full", "dots")
B, S, TOL = 2, 16, 1e-5
# the xLSTM's gradients differ from the JAX package's by up to 2.03e-5 of
# a leaf's largest |value| under every policy alike (the port's are bitwise
# the same under the three): its chunk contractions sum in other float32
# orders.  tests/test_torch_xlstm.py holds them to 1e-4 of it.
GRAD_TOL = {"xlstm-350m": 1e-4}
K, DATA = 4, 2                       # the island's and the ring's mesh
DISPATCHES = ("psum", "rs", "a2a")
RING_ARCH = "qwen2-1.5b"             # qwen2-smoke under seq_shard
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np_batch(cfg, seed=5):
    """Tokens (or frame embeddings), labels and, for the vlm family,
    image features: numpy draws from ``seed``."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    batch = {"labels": np.roll(toks, -1, 1)}
    if cfg.frontend == "embeddings":
        batch["embeddings"] = (rng.standard_normal((B, S, cfg.d_model))
                               * 0.02).astype(np.float32)
    else:
        batch["tokens"] = toks
    if cfg.family == "vlm":
        batch["image_feats"] = rng.standard_normal(
            (B, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _port_batch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _weights(arch):
    """The JAX package's smoke-config init as numpy, every cross gate
    opened to 0.75 (``init_cross`` draws 0, and tanh(0) hides the
    layer)."""
    import jax

    from repro import configs as jconfigs
    from repro.models.model import build_model as jbuild

    tree = jax.device_get(jbuild(jconfigs.reduced(arch)).init(
        jax.random.PRNGKey(0)))
    return jax.tree_util.tree_map_with_path(
        lambda path, a: np.full_like(a, 0.75)
        if getattr(path[-1], "key", None) == "gate" else np.asarray(a), tree)


@functools.lru_cache(maxsize=None)
def _jax_grads(arch, policy):
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.models.model import build_model as jbuild

    from test_torch_train import jax_arrays

    jm = jbuild(dataclasses.replace(jconfigs.reduced(arch), remat=policy))
    batch = {k: jnp.asarray(v) for k, v in _np_batch(jm.cfg).items()}
    loss, grads = jax.jit(jax.value_and_grad(jm.loss))(
        jax.tree.map(jnp.asarray, _weights(arch)), batch)
    return float(loss), jax_arrays(grads)


@functools.lru_cache(maxsize=None)
def _port_grads(arch, policy):
    """(loss, {path: grad}, checkpoint regions entered)."""
    cfg = dataclasses.replace(configs.reduced(arch), remat=policy)
    model = tmodel.build_model(cfg, device="cpu")
    params = params_from_numpy(cfg, _weights(arch), device="cpu")
    regions = []
    real = tmodel._checkpointed

    def counted(remat, fn, *args):
        regions.append(remat)
        return real(remat, fn, *args)

    tmodel._checkpointed = counted
    try:
        loss, grads = Trainer(model, AdamWConfig(lr=1e-3)).value_and_grad(
            params, _port_batch(_np_batch(cfg)))
    finally:
        tmodel._checkpointed = real
    return loss, dict(tree_paths(grads)), regions


# -- the reference subprocess: the JAX mesh's compiled gradient programs ----

def _island_cfg_jax(dispatch, policy, shared=1):
    import jax.numpy as jnp

    from repro.models.model import ModelConfig as JConfig
    from repro.models.moe import MoEDims as JDims

    return JConfig(name="tm", family="moe", n_layers=2, d_model=64,
                   n_heads=4, n_kv_heads=4, d_ff=128, vocab=128,
                   moe=JDims(n_experts=8, top_k=2, d_ff_expert=64,
                             n_shared=shared, capacity_factor=16.0,
                             dispatch=dispatch),
                   dtype=jnp.float32, remat=policy)


def _tokens(vocab, seed=3, rows=2 * DATA):
    toks = np.random.default_rng(seed).integers(0, vocab, (rows, 32))
    return {"tokens": toks.astype(np.int32),
            "labels": np.roll(toks, -1, 1).astype(np.int32)}


def _run_reference(out_path):
    """Collectives by kind of ``jax.jit(jax.grad(Model.loss))`` on the
    mesh ``("data", "model")`` = (2, 4): the island model of
    ``tests/test_torch_moe.py`` (2 layers, 8 experts, one shared, cf 16)
    for each dispatch, and qwen2-smoke under ``seq_shard`` (ring
    attention), each under the three policies."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro import configs as jconfigs
    from repro.launch.hlo_analysis import parse_collectives
    from repro.models.model import build_model as jbuild
    from repro.runtime.jax_compat import make_mesh

    mesh = make_mesh((DATA, K), ("data", "model"))
    out = {}

    def record(key, cfg):
        m = jbuild(cfg, mesh=mesh, dp_axes=("data",))
        params = jbuild(cfg).init(jax.random.PRNGKey(1))
        batch = {k: jax.device_put(jnp.asarray(v),
                                   NamedSharding(mesh, P(("data",))))
                 for k, v in _tokens(cfg.vocab).items()}
        hlo = jax.jit(jax.grad(m.loss)).lower(params, batch).compile()
        for kind, n in parse_collectives(hlo.as_text()).ops.items():
            out[f"{key}/{kind}"] = np.asarray(n)

    for policy in POLICIES:
        for dispatch in DISPATCHES:
            record(f"{dispatch}/{policy}", _island_cfg_jax(dispatch, policy))
        record(f"ring/{policy}", dataclasses.replace(
            jconfigs.reduced(RING_ARCH), tp=False, seq_shard=True,
            remat=policy))
    np.savez(out_path, **out)


@pytest.fixture(scope="module", autouse=True)
def reference_run(tmp_path_factory):
    """Start the reference subprocess when the module's first test runs,
    so it compiles while the in-process tests run: ``{"proc", "path",
    "log"}``."""
    tmp = tmp_path_factory.mktemp("remat")
    path = tmp / "reference.npz"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count"
               "=8", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([os.path.join(REPO, "src"),
                                           os.path.join(REPO, "tests")]))
    with open(tmp / "reference.log", "w+") as log:
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(path)], env=env,
            stdout=subprocess.DEVNULL, stderr=log)
        try:
            yield {"proc": proc, "path": path, "log": log}
        finally:
            if proc.poll() is None:
                proc.kill()
            proc.wait()


# -- configs ------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_carry_the_jax_remat(arch):
    from repro import configs as jconfigs

    for name in ("full", "reduced"):
        got = getattr(configs, name)(arch)
        assert got.remat == getattr(jconfigs, name)(arch).remat, name
        assert not hasattr(got, "fsdp")
    assert configs.full(arch).remat == "dots"
    assert configs.reduced(arch).remat == "none"


@pytest.mark.parametrize("policy", ["Dots", "", "selective", None])
def test_an_unknown_policy_raises(policy):
    cfg = dataclasses.replace(configs.reduced("tinyllama-1.1b"),
                              remat=policy)
    with pytest.raises(ValueError, match="remat"):
        tmodel.build_model(cfg, device="cpu")


def test_a_failure_inside_a_region_raises():
    """A cross block without image features raises inside the region;
    nothing falls back to a pass without it."""
    cfg = dataclasses.replace(configs.reduced("llama-3.2-vision-90b"),
                              remat="dots")
    model = tmodel.build_model(cfg, device="cpu")
    params = params_from_numpy(cfg, _weights("llama-3.2-vision-90b"),
                               device="cpu")
    batch = _port_batch(_np_batch(cfg))
    del batch["image_feats"]
    with pytest.raises(ValueError, match="image_feats"):
        Trainer(model, AdamWConfig(lr=1e-3)).value_and_grad(params, batch)


# -- loss and gradients ------------------------------------------------------

@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_gradients_under_each_policy(arch, policy):
    loss, grads, regions = _port_grads(arch, policy)
    superblocks = sum(reps for _, reps in configs.reduced(arch).segments())
    assert regions == ([] if policy == "none" else [policy] * superblocks)
    loss0, grads0, _ = _port_grads(arch, "none")
    assert torch.equal(loss, loss0)
    assert list(grads) == list(grads0)
    for path, g in grads.items():
        assert torch.equal(g, grads0[path]), path
    jloss, jgrads = _jax_grads(arch, policy)
    np.testing.assert_allclose(float(loss), jloss, rtol=TOL, atol=TOL)
    assert list(jgrads) == list(grads)
    for path, want in jgrads.items():
        tol = GRAD_TOL.get(arch, TOL)
        np.testing.assert_allclose(grads[path].numpy(), want, rtol=tol,
                                   atol=tol * np.abs(want).max(),
                                   err_msg=path)


# -- what a superblock keeps -------------------------------------------------

def _superblock_segment(cfg):
    """The index of a segment with the longest pattern (the MoE one of
    the moe family) and its pattern."""
    segs = cfg.segments()
    si = max(range(len(segs)), key=lambda i: (len(segs[i][0]), i))
    return si, segs[si][0]


def _port_kept(arch, policy):
    """[(shape, bytes)] of the distinct storages one superblock keeps
    for the backward, parameters left out: x first, then what the
    policy caches, in the order made."""
    base = configs.reduced(arch)
    _, pat = _superblock_segment(base)
    cfg = dataclasses.replace(base, n_layers=len(pat), first_k_dense=0,
                              remat=policy)
    model = tmodel.build_model(cfg, device="cpu")
    assert model.segs == [(pat, 1)]
    params = model.init(torch.Generator().manual_seed(0))
    leaves = [t.requires_grad_() for t in tree_leaves(params)]
    param_ptrs = {t.untyped_storage().data_ptr() for t in leaves}
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(B, S, cfg.d_model, generator=gen, requires_grad=True)
    feats = (torch.randn(B, cfg.n_image_tokens, cfg.d_model, generator=gen)
             if cfg.family == "vlm" else None)
    kept, cached = {}, []

    def pack(t):
        st = t.untyped_storage()
        if st.data_ptr() not in param_ptrs:
            kept.setdefault(st.data_ptr(), (tuple(t.shape), st.nbytes()))
        return t

    real = tmodel.dots_policy

    def recording(ctx, op, *args, **kwargs):
        decision = real(ctx, op, *args, **kwargs)
        if (not ctx.is_recompute
                and decision == torch.utils.checkpoint.CheckpointPolicy
                .MUST_SAVE):
            a, b = args[0], args[1]
            shape = (a.shape[0], b.shape[1])
            cached.append((shape, shape[0] * shape[1] * a.element_size()))
        return decision

    tmodel.dots_policy = recording
    try:
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            y, _, _ = model._run_segments(
                params, x, model._positions(B, S), differentiable=True,
                image_feats=feats)
    finally:
        tmodel.dots_policy = real
    assert y.requires_grad
    return list(kept.values()) + cached


def _jax_residuals(arch):
    """[(numel, last dim)] of the JAX superblock's scan residuals under
    ``dots``, its parameters and closed-over constants left out."""
    import jax
    import jax.numpy as jnp
    from jax._src.ad_checkpoint import saved_residuals

    from repro import configs as jconfigs
    from repro.models import model as jmodel

    cfg = jconfigs.reduced(arch)
    si, pat = _superblock_segment(cfg)
    params = jax.tree.map(jnp.asarray, _weights(arch))
    p_layer = jax.tree.map(lambda a: a[0], params["segments"][si])
    x = jnp.ones((B, S, cfg.d_model), jnp.float32)
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))
    feats = (jnp.ones((B, cfg.n_image_tokens, cfg.d_model), jnp.float32)
             if cfg.family == "vlm" else None)

    def body(x, p_layer):                 # repro.models.model's superblock
        aux_sb = jnp.zeros((), jnp.float32)
        for i, kind in enumerate(pat):
            x, _, aux = jmodel._apply_block(cfg, kind, p_layer[f"b{i}_{kind}"],
                                            x, pos, image_feats=feats)
            aux_sb = aux_sb + aux
        return x, aux_sb

    res = saved_residuals(jax.checkpoint(
        body, policy=jax.checkpoint_policies.dots_with_no_batch_dims_saveable),
        x, p_layer)
    return [(int(np.prod(a.shape)), a.shape[-1]) for a, why in res
            if "p_layer" not in why and "from a constant" not in why]


# and MLA's MoE superblock, whose last product is the shared experts'
@pytest.mark.parametrize("arch", FAMILIES + ["deepseek-v2-236b"])
def test_saved_activations_per_superblock(arch):
    kept = {p: _port_kept(arch, p) for p in POLICIES}
    nbytes = {p: sum(b for _, b in v) for p, v in kept.items()}
    assert nbytes["none"] > nbytes["dots"] > nbytes["full"]
    cfg = configs.reduced(arch)
    x_bytes = B * S * cfg.d_model * 4
    assert kept["full"] == [((B, S, cfg.d_model), x_bytes)]
    assert kept["dots"][0] == kept["full"][0]
    got = sorted((int(np.prod(s)), s[-1]) for s, _ in kept["dots"])
    assert got == sorted(_jax_residuals(arch))


# -- recomputed collectives -------------------------------------------------

_AR = 2 * (K - 1)
# per MoE layer of Model.loss (aux in the loss): (exchanges, collective
# calls, ring-kernel calls) of the forward and of the backward
# (models/moe.py's rule, tests/test_torch_moe.py's counts)
ISLAND_FWD = {
    "psum": (2 * _AR, {"all_reduce": 2}, 2),
    "rs": (2 * (K - 1) + _AR,
           {"all_gather": 1, "reduce_scatter": 1, "all_reduce": 1}, 3),
    "a2a": (2 + _AR, {"all_to_all": 2, "all_reduce": 1}, 1)}
ISLAND_BWD = {
    "psum": (4 * _AR, {"all_reduce": 4}, 4),
    "rs": (2 * (K - 1) + 2 * _AR,
           {"all_gather": 1, "reduce_scatter": 1, "all_reduce": 2}, 4),
    "a2a": (2 + 2 * _AR, {"all_to_all": 2, "all_reduce": 2}, 2)}
# recomputed under dots / full without shared experts: the collectives
# before the region's last save
ISLAND_RECOMPUTED_ALONE = {
    "psum": (0, {}, 0),
    "rs": (K - 1, {"all_gather": 1}, 1),
    "a2a": (2, {"all_to_all": 2}, 0)}


def island_recomputed(dispatch: str, shared: bool, remat: str):
    """(exchanges, calls, ring-kernel calls) a MoE layer's region runs
    again in the backward."""
    if remat == "none":
        return 0, {}, 0
    return ISLAND_FWD[dispatch] if shared else \
        ISLAND_RECOMPUTED_ALONE[dispatch]


@pytest.fixture
def ring_calls(monkeypatch):
    calls = []
    real = coll.ring_collective

    def counted(buf, schedule, *args, **kwargs):
        calls.append(schedule)
        return real(buf, schedule, *args, **kwargs)

    monkeypatch.setattr(coll, "ring_collective", counted)
    return calls


def _island_grads(dispatch, shared, policy):
    cfg = tmodel.ModelConfig(
        name="tm", family="moe", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab=128,
        moe=tmoe.MoEDims(n_experts=8, top_k=2, d_ff_expert=64,
                         n_shared=shared, capacity_factor=16.0,
                         dispatch=dispatch),
        dtype=torch.float32, remat=policy)
    ctx = ShoalContext(K, device="cpu")
    model = tmodel.build_model(cfg, device="cpu",
                               ep=tmoe.ExpertMesh(ctx, data=DATA))
    params = model.init(torch.Generator().manual_seed(0))
    loss, grads = Trainer(model, AdamWConfig(lr=1e-3)).value_and_grad(
        params, _port_batch(_tokens(cfg.vocab)))
    return ctx, loss, tree_leaves(grads)


@pytest.mark.parametrize("shared", [1, 0])
@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_island_collectives_recomputed(dispatch, shared, ring_calls):
    runs = {}
    for policy in ("none", "dots"):
        ring_calls.clear()
        ctx, loss, grads = _island_grads(dispatch, shared, policy)
        want = [0, {}, 0]
        for part in (ISLAND_FWD[dispatch], ISLAND_BWD[dispatch],
                     island_recomputed(dispatch, bool(shared), policy)):
            want[0] += 2 * part[0]
            want[2] += 2 * part[2]
            for kind, n in part[1].items():
                want[1][kind] = want[1].get(kind, 0) + 2 * n
        got_calls = {k: v for k, v in ctx.collectives.items() if v}
        assert (ctx.exchanges, got_calls, len(ring_calls)) == tuple(want), \
            policy
        runs[policy] = loss, grads
    assert torch.equal(runs["none"][0], runs["dots"][0])
    assert all(torch.equal(a, b) for a, b in zip(*(runs[p][1]
                                                   for p in runs)))


def test_ring_attention_recomputed_under_seq_shard():
    """qwen2-smoke (2 layers) with ``seq_shard`` over 4 kernels: 3
    exchanges a hop (k, v, positions), 4 hops a layer; ``dots`` runs
    every layer's ring again in the backward; the backward hands the k
    and v cotangents back every hop but the last, 2 (K - 1) a layer, as
    the compiled JAX ``value_and_grad`` counts them
    (``tests/test_torch_ring_attention.py``)."""
    runs = {}
    for policy in ("none", "dots"):
        cfg = dataclasses.replace(configs.reduced(RING_ARCH), tp=False,
                                  seq_shard=True, remat=policy)
        ctx = ShoalContext(K, device="cpu")
        model = tmodel.build_model(cfg, device="cpu",
                                   ep=tmoe.ExpertMesh(ctx, data=DATA))
        params = model.init(torch.Generator().manual_seed(0))
        loss, grads = Trainer(model, AdamWConfig(lr=1e-3)).value_and_grad(
            params, _port_batch(_tokens(cfg.vocab)))
        per_layer = 3 * K * (2 if policy == "dots" else 1) + 2 * (K - 1)
        assert ctx.exchanges == cfg.n_layers * per_layer, policy
        assert not any(ctx.collectives.values())
        runs[policy] = loss, tree_leaves(grads)
    assert torch.equal(runs["none"][0], runs["dots"][0])
    assert all(torch.equal(a, b) for a, b in zip(*(runs[p][1]
                                                   for p in runs)))


def test_the_jax_mesh_counts_beside_the_port(reference_run):
    """The JAX mesh's compiled gradient programs under each policy,
    recorded (``scripts/remat_counts.py`` prints them beside the port's
    counts); remat only adds collectives to them."""
    rc = reference_run["proc"].wait(timeout=600)
    reference_run["log"].seek(0)
    assert rc == 0, reference_run["log"].read()[-4000:]
    ref = dict(np.load(reference_run["path"]))
    for case in DISPATCHES + ("ring",):
        table = {p: {k.split("/")[-1]: int(v) for k, v in ref.items()
                     if k.startswith(f"{case}/{p}/")} for p in POLICIES}
        assert table["none"], case
        for policy in ("full", "dots"):
            for kind, n in table["none"].items():
                assert table[policy].get(kind, 0) >= n, (case, policy, kind)
    # the ring's collective-permutes are the port's exchanges of
    # test_ring_attention_recomputed_under_seq_shard: 2 layers, the
    # forward's 3 K (twice under a recomputing policy) and the
    # backward's 2 (K - 1)
    layers = configs.reduced(RING_ARCH).n_layers
    for policy in POLICIES:
        passes = 1 if policy == "none" else 2
        assert int(ref[f"ring/{policy}/collective-permute"]) \
            == layers * (3 * K * passes + 2 * (K - 1)), policy


# -- serving never enters a region ------------------------------------------

def test_serving_takes_no_region(monkeypatch):
    """prefill, decode and a forward under no_grad run the same code
    under ``dots`` as under ``none``: bitwise the same logits and
    caches, and no checkpoint region."""
    def refuse(*args):
        raise AssertionError("a serving pass entered a checkpoint region")

    out = {}
    for policy in ("none", "dots"):
        cfg = dataclasses.replace(configs.reduced("recurrentgemma-2b"),
                                  remat=policy)
        model = tmodel.build_model(cfg, device="cpu")
        params = params_from_numpy(cfg, _weights("recurrentgemma-2b"),
                                   device="cpu")
        batch = _port_batch(_np_batch(cfg))
        if policy == "dots":
            monkeypatch.setattr(tmodel, "_checkpointed", refuse)
        cache = model.make_cache(B, 24)
        logits, cache = model.prefill(params, {"tokens": batch["tokens"]},
                                      cache)
        step, cache = model.decode_step(
            params, cache, logits.argmax(-1)[:, None],
            torch.full((B,), S, dtype=torch.long))
        with torch.no_grad():
            fwd, _ = model.forward_train(params, batch, differentiable=True)
        out[policy] = [logits, step, fwd] + tree_leaves(cache)
    assert all(torch.equal(a, b) for a, b in zip(out["none"], out["dots"]))


if __name__ == "__main__":
    _run_reference(sys.argv[1])
