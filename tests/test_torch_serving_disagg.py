"""The port's disaggregated serving tier against the JAX package's.

tinyllama-smoke (``configs.reduced("tinyllama-1.1b")``, float32) with
the JAX package's ``Model.init`` weights carried across by
``models.convert.params_from_numpy``; 2 prefill + 2 decode kernels, 2
lanes per decode kernel, 16 slots.  The JAX tier needs 4 devices, so
the reference runs once, in one subprocess with 4 emulated CPU devices
(``python tests/test_torch_serving_disagg.py OUT.npz``).  Tolerance:
none anywhere.

* ``KvSegmentSpace``: leaves (path, layers, shape, words, offset),
  ``lane_words``, every lane's ``block_addrs`` and ``describe()`` equal
  to the JAX package's; its capacity, MTU and lane-range errors carry
  the JAX package's messages.
* One migration of a seeded lane cache, ``[(0, 2)]`` acked and
  unacked and the pure-local ``[(0, 0)]``: every ``PgasState`` field
  bitwise equal to the JAX package's, ``ctx.exchanges`` equal to the
  JAX migration's compiled collective-permutes (2, 1 and 0).
* ``DisaggServeTier.run`` on ``tests/serving_checks.py``'s prompts: the
  JAX tier's tokens and the solo one-lane engine's, 6 migrations at 2
  exchanges each, no error bit; then ``check_frontend``'s sequence
  through ``ServeFrontend(max_queue=2)``: the same statuses, tokens and
  ``stats()`` as the JAX front end.

The same reference holds the three other kinds of lane state, each the
smoke config of its family (``LANE_ARCHS``) with the JAX weights
(``PRNGKey(0)``) and a transport whose frame holds one lane: MLA's
latent ``ckv``, ``kr``, ``pos`` (deepseek-v2-236b), the local layers'
ring beside each RG-LRU block's float32 ``conv``, ``h``
(recurrentgemma-2b; the prompts stay within its 16-token window) and
the mLSTM ``C``, ``conv``, ``m``, ``n`` and sLSTM ``c``, ``h``, ``m``,
``n`` states (xlstm-350m): the layout and refusals as above; one acked
migration of a seeded lane (every ``PgasState`` field bitwise, the
packed lane words in the segment included, 2 exchanges, the landed lane
bitwise); the tier's tokens equal to the JAX tier's and (but for the
MoE model, whose capacity drops depend on the lanes a step routes) the
solo engine's, 6 migrations at 2 exchanges each.

In process, without JAX: the ``pack_lane`` -> ``unpack_lane`` round
trip exact in float32 and bfloat16, and the front end's pure-Python
contracts (the ports of ``tests/test_serving_disagg.py:287-405``, plus
``deadline_s=`` and ``retries=``).
"""

import dataclasses
import os
import sys
import time

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_reference import run_reference, spmd_run  # noqa: E402
from serving_checks import MAX_NEW, PROMPTS  # noqa: E402

from repro_torch.actors.events import EventMailbox, SlotEvent  # noqa: E402
from repro_torch.launch.mesh import ServingSlices  # noqa: E402
from repro_torch.serving.frontend import (  # noqa: E402
    DONE, QUEUED, REJECTED, RUNNING, TIMED_OUT, ServeFrontend)

ARCH = "tinyllama-1.1b"
K = 4                      # 2 prefill + 2 decode kernels
LANES = 2                  # lanes per decode kernel
SLOTS = 16
STATS = ("admitted", "rejected", "completed", "expired", "peak_queue_depth",
         "queue_depth", "busy_lanes")
# name -> (transport, pattern, lane): one migration each
MIGRATIONS = {"remote-acked": ("TCP", [(0, 2)], 1),
              "remote-async": ("UDP", [(1, 3)], 0),
              "local": ("TCP", [(0, 0)], 1)}
# the MLA, hybrid and xLSTM lanes: one acked migration each
LANE_ARCHS = ("deepseek-v2-236b", "recurrentgemma-2b", "xlstm-350m")
LANE_MIGRATION = ([(1, 3)], 1)
REFUSALS = ("capacity", "mtu", "lane")


def _lane_tree(cfg, seed):
    """A seeded (B=1) lane cache as the nested numpy tree both packages
    build: k / v float32, pos int32 positions and empty (-1) slots."""
    rng = np.random.default_rng(seed)
    tree = []
    for pat, reps in cfg.segments():
        seg = {}
        for i, kind in enumerate(pat):
            kv = (reps, 1, SLOTS, cfg.n_kv_heads, cfg.dh)
            seg[f"b{i}_{kind}"] = {
                "k": rng.standard_normal(kv).astype(np.float32),
                "pos": rng.integers(-1, 40, (reps, 1, SLOTS)).astype(
                    np.int32),
                "v": rng.standard_normal(kv).astype(np.float32)}
        tree.append(seg)
    return tree


def _seeded_leaves(leaves, seed):
    """Seeded numpy draws for cache leaves given in flatten order as
    ``(name, shape)``: positions in [-1, 40), every other leaf standard
    normal float32 (the two packages flatten in the same order)."""
    rng = np.random.default_rng(seed)
    return [rng.integers(-1, 40, shape).astype(np.int32) if name == "pos"
            else rng.standard_normal(shape).astype(np.float32)
            for name, shape in leaves]


def _lane_transport(tcp, lane_words, n_blocks):
    """``tcp`` with a frame that holds one lane's vectored put (the
    payload, its in-packet address list and the header)."""
    from repro_torch.core.am import HDR_WORDS

    return dataclasses.replace(
        tcp, max_packet_bytes=4 * (lane_words + n_blocks + HDR_WORDS))


def _segment0(name, seg_words):
    rng = np.random.default_rng(sorted(MIGRATIONS).index(name) + 700)
    return rng.standard_normal((K, seg_words)).astype(np.float32)


def _requests(Request):
    return [Request(i, np.asarray(p, np.int32), m)
            for i, (p, m) in enumerate(zip(PROMPTS, MAX_NEW))]


def frontend_sequence(fe):
    """``tests/serving_checks.py``'s ``check_frontend`` sequence: six
    submits into a queue of 2, run to idle, then the rejected ones
    retried with a ``pump`` between attempts.  Returns what the two
    packages must agree on."""
    jobs = [fe.submit(p, m) for p, m in zip(PROMPTS, MAX_NEW)]
    first = [j.status for j in jobs]
    fe.run_until_idle()
    pending = [(list(j.request.prompt), j.request.max_new) for j in jobs
               if j.status == REJECTED]
    attempts = []
    while pending:
        job = fe.submit(*pending[0])
        attempts.append(job.status)
        if job.status == REJECTED:
            fe.pump()
            continue
        pending.pop(0)
        jobs.append(job)
    fe.run_until_idle()
    stats = fe.stats()
    return {"first": first, "attempts": attempts,
            "final": [j.status for j in jobs],
            "tokens": [list(map(int, j.tokens)) for j in jobs],
            "stats": [stats[k] for k in STATS]}


def _pad(rows):
    out = np.full((len(rows), max(map(len, rows), default=0)), -1, np.int64)
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
    return out


# -- the reference ---------------------------------------------------------------

def _run_reference(out_path):
    import jax
    import jax.numpy as jnp

    from repro import configs, runtime
    from repro.core.address_space import GlobalAddressSpace
    from repro.core.state import ShoalContext
    from repro.launch.mesh import ServingSlices as JSlices
    from repro.models.model import build_model
    from repro.serving import Request, ServeFrontend as JFrontend
    from repro.serving.disagg import DisaggServeTier, _lane_words
    from repro.serving.kv_space import KvSegmentSpace

    cfg = configs.reduced(ARCH)
    model = build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    mesh = runtime.make_cpu_mesh(K, ("kernel",))
    lane_words = _lane_words(model, SLOTS)
    out = {}

    def space(seg_words=LANES * lane_words, transport=runtime.TCP,
              lanes=LANES):
        ctx = ShoalContext(mesh=mesh, axes=("kernel",), transport=transport,
                           segment_words=seg_words)
        gas = GlobalAddressSpace(ctx)
        return gas, KvSegmentSpace(gas, model, lanes=lanes, slots=SLOTS)

    # layout
    _, kv = space()
    out["layout/lane_words"] = np.asarray(kv.lane_words)
    out["layout/leaves"] = np.asarray([repr((leaf.path, leaf.layers,
                                             leaf.shape, leaf.words,
                                             leaf.offset))
                                       for leaf in kv.leaves])
    out["layout/describe"] = np.asarray(kv.describe())
    out["layout/addrs"] = np.asarray([[kv.block_addrs(lane, kernel=k)
                                       for k in range(K)]
                                      for lane in range(LANES)])
    # refusals: the message is what is compared
    refusals = {
        "capacity": lambda: space(seg_words=LANES * lane_words - 1),
        "mtu": lambda: space(transport=dataclasses.replace(
            runtime.TCP, max_packet_bytes=4 * lane_words)),
        "lane": lambda: kv.lane_base(LANES),
    }
    for name, fn in refusals.items():
        try:
            fn()
            out[f"refusal/{name}"] = np.asarray("nothing")
        except ValueError as e:
            out[f"refusal/{name}"] = np.asarray(str(e))
    # one migration each
    for name, (transport, pattern, lane) in MIGRATIONS.items():
        gas, kv = space(transport=getattr(runtime, transport))
        seg0 = _segment0(name, gas.segment_words)
        st0 = gas.make_global_state(seg0.reshape(-1))
        blocks = [jnp.asarray(np.broadcast_to(np.asarray(b), (K,) + b.shape))
                  for b in kv.pack_lane(_lane_tree(cfg, 11))]

        def fn(st, *blocks, kv=kv, pattern=pattern, lane=lane):
            return kv.migrate(st, list(blocks), pattern, lane), ()

        st, _, cps, _ = spmd_run(mesh, fn, st0, *blocks)
        for f in dataclasses.fields(st):
            out[f"migrate/{name}/{f.name}"] = np.asarray(getattr(st, f.name))
        out[f"migrate/{name}/cps"] = np.asarray(cps)
    # the tier, then the front end over the same tier
    tier = DisaggServeTier(model, params, JSlices(n_prefill=2, n_decode=2),
                           lanes_per_decode=LANES, slots=SLOTS)
    reqs = _requests(Request)
    done = tier.run(reqs)
    out["tier/done"] = np.asarray([r.rid for r in done])
    out["tier/tokens"] = _pad([r.out for r in reqs])
    out["tier/migrations"] = np.asarray(tier.migrations)
    out["tier/error"] = np.asarray(tier.state.error)
    seq = frontend_sequence(JFrontend(tier, max_queue=2))
    for key in ("first", "attempts", "final"):
        out[f"frontend/{key}"] = np.asarray(seq[key])
    out["frontend/tokens"] = _pad(seq["tokens"])
    out["frontend/stats"] = np.asarray(seq["stats"])
    out["frontend/migrations"] = np.asarray(tier.migrations)
    for arch in LANE_ARCHS:
        _lane_reference(out, arch, mesh)
    np.savez(out_path, **out)


def _lane_reference(out, arch, mesh):
    """One family's lane: layout, refusals, an acked migration of a
    seeded lane and the tier's tokens, under ``lanes/ARCH/...``."""
    import jax
    import jax.numpy as jnp

    from repro import configs, runtime
    from repro.core.address_space import GlobalAddressSpace
    from repro.core.state import ShoalContext
    from repro.launch.mesh import ServingSlices as JSlices
    from repro.models.model import build_model
    from repro.serving import Request
    from repro.serving.disagg import DisaggServeTier, _lane_words
    from repro.serving.kv_space import KvSegmentSpace

    key = f"lanes/{arch}"
    model = build_model(configs.reduced(arch))
    params = model.init(jax.random.PRNGKey(0))
    lane_words = _lane_words(model, SLOTS)
    proto = model.make_cache(1, SLOTS)
    n_blocks = sum(x.shape[0] for x in jax.tree.leaves(proto))
    transport = _lane_transport(runtime.TCP, lane_words, n_blocks)

    def space(seg_words=LANES * lane_words, transport=transport):
        ctx = ShoalContext(mesh=mesh, axes=("kernel",), transport=transport,
                           segment_words=seg_words)
        gas = GlobalAddressSpace(ctx)
        return gas, KvSegmentSpace(gas, model, lanes=LANES, slots=SLOTS)

    gas, kv = space()
    out[f"{key}/layout/lane_words"] = np.asarray(kv.lane_words)
    out[f"{key}/layout/leaves"] = np.asarray([repr((
        leaf.path, leaf.layers, leaf.shape, leaf.words, leaf.offset))
        for leaf in kv.leaves])
    out[f"{key}/layout/describe"] = np.asarray(kv.describe())
    out[f"{key}/layout/addrs"] = np.asarray([[kv.block_addrs(lane, kernel=k)
                                              for k in range(K)]
                                             for lane in range(LANES)])
    refusals = {
        "capacity": lambda: space(seg_words=LANES * lane_words - 1),
        "mtu": lambda: space(transport=dataclasses.replace(
            runtime.TCP, max_packet_bytes=4 * lane_words)),
        "lane": lambda: kv.lane_base(LANES),
    }
    for name, fn in refusals.items():
        try:
            fn()
            out[f"{key}/refusal/{name}"] = np.asarray("nothing")
        except ValueError as e:
            out[f"{key}/refusal/{name}"] = np.asarray(str(e))
    flat, treedef = jax.tree_util.tree_flatten_with_path(proto)
    leaves = _seeded_leaves([(str(path[-1].key), x.shape)
                             for path, x in flat], 11)
    lane_tree = jax.tree_util.tree_unflatten(treedef, leaves)
    pattern, lane = LANE_MIGRATION
    seg0 = _segment0("remote-acked", gas.segment_words)
    st0 = gas.make_global_state(seg0.reshape(-1))
    blocks = [jnp.asarray(np.broadcast_to(np.asarray(b), (K,) + b.shape))
              for b in kv.pack_lane(lane_tree)]

    def fn(st, *blocks):
        return kv.migrate(st, list(blocks), pattern, lane), ()

    st, _, cps, _ = spmd_run(mesh, fn, st0, *blocks)
    for f in dataclasses.fields(st):
        out[f"{key}/migrate/{f.name}"] = np.asarray(getattr(st, f.name))
    out[f"{key}/migrate/cps"] = np.asarray(cps)
    tier = DisaggServeTier(model, params, JSlices(n_prefill=2, n_decode=2),
                           lanes_per_decode=LANES, slots=SLOTS,
                           transport=transport)
    reqs = _requests(Request)
    tier.run(reqs)
    out[f"{key}/tier/tokens"] = _pad([r.out for r in reqs])
    out[f"{key}/tier/migrations"] = np.asarray(tier.migrations)
    out[f"{key}/tier/error"] = np.asarray(tier.state.error)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(__file__,
                         tmp_path_factory.mktemp("disagg") / "ref.npz",
                         devices=K)


@pytest.fixture(scope="module")
def smoke():
    """The port's tinyllama-smoke with the JAX package's weights."""
    import jax

    from repro import configs as jconfigs
    from repro.models.model import build_model as jbuild
    from repro_torch import configs
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.models.model import build_model

    jparams = jbuild(jconfigs.reduced(ARCH)).init(jax.random.PRNGKey(0))
    cfg = configs.reduced(ARCH)
    model = build_model(cfg, device="cpu")
    return model, params_from_numpy(cfg, jax.device_get(jparams),
                                    device="cpu")


def _space(model, seg_words=None, transport=None, lanes=LANES,
           num_kernels=K):
    from repro_torch import runtime
    from repro_torch.core.address_space import GlobalAddressSpace
    from repro_torch.core.state import ShoalContext
    from repro_torch.serving.disagg import _lane_words
    from repro_torch.serving.kv_space import KvSegmentSpace

    if seg_words is None:
        seg_words = lanes * _lane_words(model, SLOTS)
    ctx = ShoalContext(num_kernels, transport or runtime.TCP, seg_words,
                       device="cpu")
    gas = GlobalAddressSpace(ctx)
    return gas, KvSegmentSpace(gas, model, lanes=lanes, slots=SLOTS)


# -- the KV layout ------------------------------------------------------------------

def test_kv_layout_matches_reference(reference, smoke):
    model, _ = smoke
    _, kv = _space(model)
    assert kv.lane_words == int(reference["layout/lane_words"])
    got = [repr((leaf.path, leaf.layers, leaf.shape, leaf.words,
                 leaf.offset)) for leaf in kv.leaves]
    assert got == list(reference["layout/leaves"])
    assert [leaf.path for leaf in kv.leaves] == [
        "0/b0_dense/k", "0/b0_dense/pos", "0/b0_dense/v"]
    assert kv.describe() == str(reference["layout/describe"])
    addrs = [[kv.block_addrs(lane, kernel=k) for k in range(K)]
             for lane in range(LANES)]
    np.testing.assert_array_equal(np.asarray(addrs),
                                  reference["layout/addrs"])
    assert kv.n_blocks == len(addrs[0][0]) == 3 * model.cfg.n_layers


@pytest.mark.parametrize("name", ["capacity", "mtu", "lane"])
def test_kv_refusals_match_reference(reference, smoke, name):
    from repro_torch import runtime
    from repro_torch.serving.disagg import _lane_words

    model, _ = smoke
    lane_words = _lane_words(model, SLOTS)
    _, kv = _space(model)
    calls = {
        "capacity": lambda: _space(model, seg_words=LANES * lane_words - 1),
        "mtu": lambda: _space(model, transport=dataclasses.replace(
            runtime.TCP, max_packet_bytes=4 * lane_words)),
        "lane": lambda: kv.lane_base(LANES),
    }
    with pytest.raises(ValueError) as err:
        calls[name]()
    assert str(err.value) == str(reference[f"refusal/{name}"])


def test_pack_lane_refuses_a_foreign_structure(smoke):
    from repro_torch.models.convert import cache_from_numpy

    model, _ = smoke
    _, kv = _space(model)
    tree = _lane_tree(model.cfg, 1)
    del tree[0]["b0_dense"]["pos"]
    with pytest.raises(ValueError, match="does not match"):
        kv.pack_lane(cache_from_numpy(model.cfg, tree, device="cpu"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pack_unpack_round_trip_is_exact(smoke, dtype):
    """A lane packed onto float32 segment words, landed by a pure-local
    migration and rebuilt by ``unpack_lane`` equals the lane bitwise:
    k / v in their dtype, pos int32."""
    from repro_torch.models.convert import cache_from_numpy
    from repro_torch.models.model import build_model
    from repro_torch.serving.kv_space import MIGRATE_TOKEN

    cfg = dataclasses.replace(smoke[0].cfg, dtype=getattr(torch, dtype))
    model = build_model(cfg, device="cpu")
    gas, kv = _space(model, num_kernels=1)
    lane_cache = cache_from_numpy(cfg, _lane_tree(cfg, 5), device="cpu")
    for lane in range(LANES):
        st = kv.migrate(gas.make_global_state(), kv.pack_lane(lane_cache),
                        [(0, 0)], lane)
        assert int(st.error[0]) == 0 and int(st.credits[0, MIGRATE_TOKEN]) == 0
        got = kv.unpack_lane(st.segment[0], lane)
        for name in ("k", "pos", "v"):
            want = lane_cache[0]["b0_dense"][name]
            have = got[0]["b0_dense"][name]
            assert have.dtype == want.dtype and have.shape == want.shape
            assert torch.equal(have, want), (dtype, lane, name)
        assert gas.ctx.exchanges == 0


# -- one migration -------------------------------------------------------------------

@pytest.mark.parametrize("name", list(MIGRATIONS))
def test_migration_matches_reference(reference, smoke, name):
    from repro_torch import runtime
    from repro_torch.core.state import state_to_numpy
    from repro_torch.models.convert import cache_from_numpy

    model, _ = smoke
    transport, pattern, lane = MIGRATIONS[name]
    gas, kv = _space(model, transport=getattr(runtime, transport))
    st0 = gas.make_global_state(
        _segment0(name, gas.segment_words).reshape(-1))
    lane_cache = cache_from_numpy(model.cfg, _lane_tree(model.cfg, 11),
                                  device="cpu")
    st = kv.migrate(st0, kv.pack_lane(lane_cache), pattern, lane)
    for f, arr in state_to_numpy(st).items():
        np.testing.assert_array_equal(arr, reference[f"migrate/{name}/{f}"],
                                      err_msg=f"{name}: {f}")
    cps = int(reference[f"migrate/{name}/cps"])
    assert gas.ctx.exchanges == cps == {"remote-acked": 2, "remote-async": 1,
                                        "local": 0}[name]
    # the decode side's view of the landed lane is the lane
    got = kv.unpack_lane(st.segment[pattern[0][1]], lane)
    for key in ("k", "pos", "v"):
        assert torch.equal(got[0]["b0_dense"][key],
                           lane_cache[0]["b0_dense"][key])


# -- the tier and its front end ------------------------------------------------------

def test_tier_and_frontend_match_reference(reference, smoke):
    from repro_torch.serving import DisaggServeTier, Request, ServeEngine

    model, params = smoke
    tier = DisaggServeTier(model, params, ServingSlices(2, 2),
                           lanes_per_decode=LANES, slots=SLOTS, device="cpu")
    reqs = _requests(Request)
    e0 = tier.ctx.exchanges
    done = tier.run(reqs)
    assert [r.rid for r in done] == list(reference["tier/done"])
    np.testing.assert_array_equal(_pad([r.out for r in reqs]),
                                  reference["tier/tokens"])
    assert tier.migrations == int(reference["tier/migrations"]) == 6
    assert tier.ctx.exchanges - e0 == 2 * tier.migrations
    np.testing.assert_array_equal(tier.state.error.numpy(),
                                  reference["tier/error"])
    assert (tier.state.error == 0).all()
    assert (tier.state.credits == 0).all()
    # the solo one-lane engine, request by request
    oracle = ServeEngine(model, params, lanes=1, slots=SLOTS)
    for req in reqs:
        ref = Request(req.rid, req.prompt, req.max_new)
        oracle.run([ref])
        assert req.out == ref.out and len(req.out) == req.max_new, req.rid
    # check_frontend's sequence on the same tier
    seq = frontend_sequence(ServeFrontend(tier, max_queue=2))
    for key in ("first", "attempts", "final"):
        assert seq[key] == list(reference[f"frontend/{key}"]), key
    np.testing.assert_array_equal(_pad(seq["tokens"]),
                                  reference["frontend/tokens"])
    assert seq["stats"] == list(reference["frontend/stats"])
    assert tier.migrations == int(reference["frontend/migrations"])
    assert set(seq["final"]) == {DONE, REJECTED}
    assert seq["stats"][STATS.index("busy_lanes")] == 0


def test_example_runs_on_the_cpu():
    """``examples/torch_serve_disagg.py --device cpu`` with JAX and the
    JAX package blocked: the layout, one migration at 2 exchanges,
    backpressure and the served jobs."""
    import subprocess

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import runpy, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "sys.argv = ['torch_serve_disagg.py', '--device', 'cpu']\n"
            "runpy.run_path("
            f"{os.path.join(repo, 'examples', 'torch_serve_disagg.py')!r}, "
            "run_name='__main__')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(repo, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout
    assert "0/b0_dense/k: 2 layers x 512 words" in out
    assert "took 2 exchanges" in out
    assert "rejected (backpressure)" in out and "error words [0, 0, 0, 0]" \
        in out


# -- the MLA, hybrid and xLSTM lanes ----------------------------------------------

_LANE_MODELS = {}


def lane_model(arch):
    """The port's smoke model of ``arch`` with the JAX package's
    ``PRNGKey(0)`` weights, and its lane transport."""
    if arch not in _LANE_MODELS:
        import jax

        from repro import configs as jconfigs
        from repro.models.model import build_model as jbuild
        from repro_torch import configs, runtime
        from repro_torch.models.convert import params_from_numpy
        from repro_torch.models.model import build_model
        from repro_torch.serving.disagg import _lane_words

        jparams = jbuild(jconfigs.reduced(arch)).init(jax.random.PRNGKey(0))
        cfg = configs.reduced(arch)
        model = build_model(cfg, device="cpu")
        n_blocks = sum(leaf.shape[0] for seg in model.make_cache(1, SLOTS)
                       for blk in seg.values() for leaf in blk.values())
        _LANE_MODELS[arch] = (model, params_from_numpy(
            cfg, jax.device_get(jparams), device="cpu"), _lane_transport(
            runtime.TCP, _lane_words(model, SLOTS), n_blocks))
    return _LANE_MODELS[arch]


def _seeded_lane(model, seed):
    """:func:`_seeded_leaves` in the port's (B=1) lane tree."""
    from repro_torch.models.convert import cache_from_numpy
    from repro_torch.tree import tree_paths, tree_unflatten

    proto = model.make_cache(1, SLOTS)
    leaves = _seeded_leaves([(p.split("/")[-1], tuple(x.shape))
                             for p, x in tree_paths(proto)], seed)
    return cache_from_numpy(model.cfg, tree_unflatten(proto, leaves),
                            device="cpu")


@pytest.mark.parametrize("arch", LANE_ARCHS)
def test_lane_layout_matches_reference(reference, arch):
    model, _, transport = lane_model(arch)
    key = f"lanes/{arch}"
    _, kv = _space(model, transport=transport)
    assert kv.lane_words == int(reference[f"{key}/layout/lane_words"])
    got = [repr((leaf.path, leaf.layers, leaf.shape, leaf.words,
                 leaf.offset)) for leaf in kv.leaves]
    assert got == list(reference[f"{key}/layout/leaves"])
    assert kv.describe() == str(reference[f"{key}/layout/describe"])
    addrs = [[kv.block_addrs(lane, kernel=k) for k in range(K)]
             for lane in range(LANES)]
    np.testing.assert_array_equal(np.asarray(addrs),
                                  reference[f"{key}/layout/addrs"])
    names = {leaf.path.split("/")[-1] for leaf in kv.leaves}
    assert names == {"deepseek-v2-236b": {"ckv", "kr", "pos"},
                     "recurrentgemma-2b": {"conv", "h", "k", "pos", "v"},
                     "xlstm-350m": {"C", "c", "conv", "h", "m", "n"}}[arch]


@pytest.mark.parametrize("name", REFUSALS)
@pytest.mark.parametrize("arch", LANE_ARCHS)
def test_lane_refusals_match_reference(reference, arch, name):
    from repro_torch import runtime
    from repro_torch.serving.disagg import _lane_words

    model, _, transport = lane_model(arch)
    lane_words = _lane_words(model, SLOTS)
    _, kv = _space(model, transport=transport)
    calls = {
        "capacity": lambda: _space(model, seg_words=LANES * lane_words - 1,
                                   transport=transport),
        "mtu": lambda: _space(model, transport=dataclasses.replace(
            runtime.TCP, max_packet_bytes=4 * lane_words)),
        "lane": lambda: kv.lane_base(LANES),
    }
    with pytest.raises(ValueError) as err:
        calls[name]()
    assert str(err.value) == str(reference[f"lanes/{arch}/refusal/{name}"])


@pytest.mark.parametrize("arch", LANE_ARCHS)
def test_lane_pack_refuses_a_foreign_structure(arch):
    model, _, transport = lane_model(arch)
    _, kv = _space(model, transport=transport)
    lane = _seeded_lane(model, 1)
    blk = lane[0][sorted(lane[0])[0]]
    del blk[sorted(blk)[0]]
    with pytest.raises(ValueError, match="does not match"):
        kv.pack_lane(lane)


@pytest.mark.parametrize("arch", LANE_ARCHS)
def test_lane_migration_matches_reference(reference, arch):
    """The packed lane words land where the JAX tier's do: every state
    field bitwise, 2 exchanges, and ``unpack_lane`` gives the lane back
    bitwise (float32 states, int32 positions)."""
    from repro_torch.core.state import state_to_numpy
    from repro_torch.tree import tree_paths

    model, _, transport = lane_model(arch)
    key = f"lanes/{arch}"
    pattern, lane = LANE_MIGRATION
    gas, kv = _space(model, transport=transport)
    st0 = gas.make_global_state(
        _segment0("remote-acked", gas.segment_words).reshape(-1))
    lane_cache = _seeded_lane(model, 11)
    st = kv.migrate(st0, kv.pack_lane(lane_cache), pattern, lane)
    for f, arr in state_to_numpy(st).items():
        np.testing.assert_array_equal(arr, reference[f"{key}/migrate/{f}"],
                                      err_msg=f"{arch}: {f}")
    assert gas.ctx.exchanges == int(reference[f"{key}/migrate/cps"]) == 2
    got = dict(tree_paths(kv.unpack_lane(st.segment[pattern[0][1]], lane)))
    for path, want in tree_paths(lane_cache):
        assert got[path].dtype == want.dtype, path
        assert torch.equal(got[path], want), path


@pytest.mark.parametrize("arch", LANE_ARCHS)
def test_lane_tier_matches_reference(reference, arch):
    from repro_torch.serving import DisaggServeTier, Request, ServeEngine

    model, params, transport = lane_model(arch)
    key = f"lanes/{arch}"
    tier = DisaggServeTier(model, params, ServingSlices(2, 2),
                           lanes_per_decode=LANES, slots=SLOTS,
                           transport=transport, device="cpu")
    reqs = _requests(Request)
    e0 = tier.ctx.exchanges
    tier.run(reqs)
    np.testing.assert_array_equal(_pad([r.out for r in reqs]),
                                  reference[f"{key}/tier/tokens"])
    assert tier.migrations == int(reference[f"{key}/tier/migrations"]) == 6
    assert tier.ctx.exchanges - e0 == 2 * tier.migrations
    np.testing.assert_array_equal(tier.state.error.numpy(),
                                  reference[f"{key}/tier/error"])
    assert (tier.state.error == 0).all() and (tier.state.credits == 0).all()
    if model.cfg.moe is not None:
        return      # a one-lane step routes fewer pairs: other MoE drops
    oracle = ServeEngine(model, params, lanes=1, slots=SLOTS)
    for req in reqs:
        ref = Request(req.rid, req.prompt, req.max_new)
        oracle.run([ref])
        assert req.out == ref.out, (arch, req.rid)


# -- serving slices (pure topology logic) --------------------------------------------

def test_serving_slices():
    s = ServingSlices(n_prefill=2, n_decode=3)
    assert s.num_kernels == 5
    assert s.prefill_ids == (0, 1) and s.decode_ids == (2, 3, 4)
    assert s.role_of(1) == "prefill" and s.role_of(4) == "decode"
    assert s.migration_pattern(0, 3) == [(0, 3)]
    with pytest.raises(ValueError, match="not in the prefill"):
        s.migration_pattern(3, 2)
    with pytest.raises(ValueError, match="not in the decode"):
        s.migration_pattern(0, 1)
    with pytest.raises(ValueError, match="outside"):
        s.role_of(5)
    with pytest.raises(ValueError, match=">= 1"):
        ServingSlices(n_prefill=0, n_decode=1)
    with pytest.raises(dataclasses.FrozenInstanceError):
        s.n_prefill = 3


# -- admission front end (pure Python) -----------------------------------------------

class FakeEngine:
    """Pure-Python ServeEngine stand-in: same scheduler surface, same
    EventMailbox accounting, no model."""

    def __init__(self, lanes=2, steps=3):
        self.events = EventMailbox(watermark=1000)
        self.active = [None] * lanes
        self._left = [0] * lanes
        self.steps = steps

    def find_free_lane(self):
        for lane, cur in enumerate(self.active):
            if cur is None:
                return lane
        return None

    def submit(self, req):
        lane = self.find_free_lane()
        if lane is None:
            return False
        self.active[lane] = req
        self._left[lane] = self.steps
        req.out.append(1)
        self.events.send(SlotEvent("acquire", lane, req.rid))
        return True

    def step(self):
        for lane, req in enumerate(self.active):
            if req is None:
                continue
            req.out.append(0)
            self._left[lane] -= 1
            if self._left[lane] <= 0:
                req.done = True
                self.active[lane] = None
                self.events.send(SlotEvent("release", lane, req.rid))
        self.events.flush()

    @property
    def idle(self):
        return all(r is None for r in self.active)

    def drain(self):
        return self.events.flush()


def test_frontend_backpressure_rejects_beyond_bound():
    fe = ServeFrontend(FakeEngine(lanes=1, steps=2), max_queue=2)
    jobs = [fe.submit([1, 2], max_new=3) for _ in range(5)]
    assert [j.status for j in jobs] == [QUEUED, QUEUED,
                                        REJECTED, REJECTED, REJECTED]
    assert fe.queue_depth == 2 and fe.peak_queue_depth == 2
    fe.run_until_idle()
    assert [j.status for j in jobs[:2]] == [DONE, DONE]
    assert fe.peak_queue_depth <= fe.max_queue
    with pytest.raises(ValueError, match="rejected"):
        fe.result(jobs[2].rid)
    stats = fe.stats()
    assert stats["admitted"] == 2 and stats["rejected"] == 3
    assert stats["completed"] == 2 and stats["busy_lanes"] == 0
    with pytest.raises(ValueError, match=">= 1"):
        ServeFrontend(FakeEngine(), max_queue=0)


def test_frontend_status_flow_is_event_driven():
    fe = ServeFrontend(FakeEngine(lanes=1, steps=2), max_queue=4)
    job = fe.submit([5], max_new=3)
    assert fe.status(job.rid) == QUEUED
    assert fe.result(job.rid) is None
    fe.pump()
    assert fe.status(job.rid) == RUNNING
    assert fe.stats()["busy_lanes"] == 1      # acquire event landed
    while fe.pump():
        pass
    assert fe.status(job.rid) == DONE         # release event marked it
    assert fe.result(job.rid) == job.request.out
    with pytest.raises(KeyError):
        fe.status(999)


def test_frontend_runner_thread():
    fe = ServeFrontend(FakeEngine(lanes=2, steps=2), max_queue=8)
    fe.start(poll_s=0.0005)
    try:
        jobs = [fe.submit([i], max_new=3) for i in range(6)]
        deadline = time.monotonic() + 10
        while (any(j.status != DONE for j in jobs)
               and time.monotonic() < deadline):
            time.sleep(0.002)
    finally:
        fe.stop()
    assert all(j.status == DONE for j in jobs)
    with pytest.raises(RuntimeError, match="already started"):
        fe.start(), fe.start()
    fe.stop()


def test_frontend_stop_raises_on_a_wedged_runner():
    """``stop`` does not take a join that timed out for success: the
    runner is kept and the engine is not drained."""
    class Wedged(FakeEngine):
        def step(self):
            gate.wait(5)
            super().step()

    import threading

    gate = threading.Event()
    engine = Wedged(lanes=1, steps=1)
    fe = ServeFrontend(engine, max_queue=2)
    fe.submit([1], max_new=2)
    fe.start(poll_s=0.0005)
    time.sleep(0.05)
    with pytest.raises(RuntimeError, match="failed to stop"):
        fe.stop(timeout=0.05)
    gate.set()
    fe.stop()
    assert fe._runner is None


def test_frontend_deadline_times_out_queued_jobs():
    fe = ServeFrontend(FakeEngine(lanes=1, steps=3), max_queue=4)
    first = fe.submit([1], max_new=4)
    late = fe.submit([2], max_new=4, deadline_s=0.001)
    keep = fe.submit([3], max_new=4, deadline_s=60.0)
    time.sleep(0.01)
    fe.pump()               # first takes the lane; late is overdue
    assert fe.status(first.rid) == RUNNING
    assert fe.status(late.rid) == TIMED_OUT
    assert fe.status(keep.rid) == QUEUED
    with pytest.raises(ValueError, match="timed out"):
        fe.result(late.rid)
    fe.run_until_idle()
    assert fe.status(keep.rid) == DONE and fe.status(first.rid) == DONE
    stats = fe.stats()
    assert stats["expired"] == 1 and stats["completed"] == 2
    assert late.request.out == []            # never served


def test_frontend_retries_back_off_then_reject_or_admit():
    fe = ServeFrontend(FakeEngine(lanes=1, steps=2), max_queue=1)
    first = fe.submit([1], max_new=3)
    t0 = time.monotonic()
    refused = fe.submit([2], max_new=3, retries=2, backoff_s=0.004)
    waited = time.monotonic() - t0
    assert refused.status == REJECTED
    assert waited >= 0.004 + 0.008           # two backoffs, doubling
    assert fe.stats()["rejected"] == 1
    # with a runner draining the queue, a retrying submit gets in
    fe.start(poll_s=0.0005)
    try:
        admitted = fe.submit([3], max_new=3, retries=200, backoff_s=0.001)
        deadline = time.monotonic() + 10
        while (admitted.status != DONE or first.status != DONE) \
                and time.monotonic() < deadline:
            time.sleep(0.002)
    finally:
        fe.stop()
    assert admitted.status == DONE and first.status == DONE
    assert fe.stats()["peak_queue_depth"] <= 1


if __name__ == "__main__":
    _run_reference(sys.argv[1])
