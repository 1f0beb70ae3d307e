"""The port's ring collectives, HUMboldt and RDMA ring all-reduce on 8
kernels against the JAX package's, and the GAScore's masked lanes.

The JAX reference runs every 8-kernel case once, in one subprocess with
8 emulated CPU devices (``python tests/test_torch_collectives.py
OUT.npz`` writes its results): the collectives and HUMboldt under
``shard_map``, ``ring_allreduce_dma`` in Pallas interpret mode.  The
port runs the same inputs, made from a seed with numpy, on the CPU
along its kernel axis.  Tolerance: none.  Results are compared bitwise
(as int32 words; bfloat16 results as their exact float32 values), so
-0.0 differs from 0.0 and NaN must be the same NaN: both sides add in
the same order and round to the input's type after every add.
Exchange counts are held to their closed forms: n-1 per reduce-scatter
or all-gather, 2(n-1) per all-reduce or broadcast, 1 per all-to-all, 0
per barrier and at n = 1, and 4 per HUMboldt segment.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

N = 8
RING = [(i, (i + 1) % N) for i in range(N)]
EVEN = [(i, i + 1) for i in range(0, N, 2)]          # 0->1, 2->3, ...
SMALL = 64                                           # bytes: 16-word MTU

# collective cases: name -> (per-kernel shape, dtype, seed)
COLL = {
    "f32-37": ((37,), "float32", 0),
    "f32-40": ((40,), "float32", 1),
    "f32-1": ((1,), "float32", 2),
    "f32-4x10": ((4, 10), "float32", 3),
    "i32-37": ((37,), "int32", 4),
}
# Pallas RDMA ring cases: name -> (chunk, dtype); md_checks.py's shapes
DMA_CASES = {"f32-128": (128, "float32"), "bf16-64": (64, "bfloat16")}
# HUMboldt cases: name -> (payload words, pattern, MTU bytes)
HUM = {"ring-3w": (3, RING, 9000), "even-40w-mtu64": (40, EVEN, SMALL)}
# masked-lane op cases: name -> MTU bytes
MASKED = {"mtu64": SMALL, "mtu9000": 9000}
MASKED_SEG = 64


def _coll_input(name):
    shape, dtype, seed = COLL[name]
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        return rng.integers(-127, 128, (N,) + shape).astype(np.int32)
    x = rng.standard_normal((N,) + shape).astype(np.float32)
    x.reshape(N, -1)[:, ::7] = 0.0                    # payloads hold zeros
    return x


def _dma_input(name):
    chunk, _ = DMA_CASES[name]
    return np.random.default_rng(0).standard_normal(N * chunk)


def _hum_input(name):
    words = HUM[name][0]
    return (np.arange(1, N + 1, dtype=np.float32)[:, None]
            * np.linspace(-2, 3, words, dtype=np.float32))


def _poison(a, rng):
    """Sprinkle NaN, +inf, -inf and negative values over ``a``."""
    a = np.array(a, np.float32)
    flat = a.reshape(-1)
    idx = rng.permutation(flat.size)
    q = flat.size // 8
    flat[idx[:q]] = np.nan
    flat[idx[q:2 * q]] = np.inf
    flat[idx[2 * q:3 * q]] = -np.inf
    flat[idx[3 * q:5 * q]] = -np.abs(flat[idx[3 * q:5 * q]]) - 1.0
    return a


def _masked_inputs(name):
    rng = np.random.default_rng(sorted(MASKED).index(name) + 50)
    seg = _poison(rng.standard_normal((N, MASKED_SEG)), rng)
    pay = _poison(rng.standard_normal((N, 20)), rng)
    return seg, pay


def _masked_prog(ops, ctx, st, pay):
    st, fifo = ops.put_medium(ctx, st, pay, RING, token=1)
    st = ops.wait_replies(ctx, st, token=1, n=1)
    st, mem = ops.put_medium(ctx, st, None, EVEN, from_segment_addr=10,
                             nwords=20, token=2)
    st, got = ops.get_medium(ctx, st, RING, src_addr=5, nwords=20, token=3)
    st = ops.wait_replies(ctx, st, token=3, n=1)
    return st, (fifo, mem, got)


def _bits(a):
    """Bitwise view of a result: int32 words (bfloat16 through its exact
    float32 value)."""
    a = np.asarray(a)
    if a.dtype != np.int32:
        a = a.astype(np.float32)
    return a.view(np.int32)


def _hum_waits(ctx, name):
    """Credits each kernel waits for after ``sendrecv``: one completion
    per segment, on the senders."""
    words, pattern, mtu = HUM[name]
    segments = -(-words // (mtu // 4))
    return segments * (1 - ctx.my_id() % 2) if pattern is EVEN else segments


def _transport(runtime, mtu):
    return dataclasses.replace(runtime.TCP, max_packet_bytes=mtu)


def _run_reference(out_path):
    """Every 8-kernel case on the JAX package; writes npz."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro import runtime
    from repro.core import collectives as coll, humboldt, ops
    from repro.core.address_space import GlobalAddressSpace
    from repro.core.state import ShoalContext
    from repro.kernels.gascore_dma import ring_allreduce_dma
    from repro.runtime.jax_compat import make_mesh, shard_map

    mesh = runtime.make_cpu_mesh(N, ("kernel",))
    ax = ("kernel",)
    spec = P(ax)
    out = {}

    def per_kernel(fn, *xs):
        """Run ``fn`` on every kernel's slice (leading 1 dropped)."""
        def inner(*a):
            res = fn(*(v[0] for v in a))
            return tuple(r[None] for r in res)
        return jax.jit(shard_map(inner, mesh=mesh, in_specs=(spec,) * len(xs),
                                 out_specs=spec))(*xs)

    for name in COLL:
        x = jnp.asarray(_coll_input(name))
        ar, rs, bc0, bc5 = per_kernel(lambda v: (
            coll.ring_all_reduce(v, ax, N), coll.ring_reduce_scatter(v, ax, N),
            coll.broadcast_from(v, ax, N, root=0),
            coll.broadcast_from(v, ax, N, root=5)), x)
        (ag,) = per_kernel(lambda c: (coll.ring_all_gather(c, ax, N),), rs)
        for key, val in dict(ar=ar, rs=rs, ag=ag, bc0=bc0, bc5=bc5).items():
            out[f"coll/{name}/{key}"] = np.asarray(val)

    a2a_in = np.arange(N * 16 * 3, dtype=np.int32).reshape(N, 16, 3)
    a2a_untiled = np.arange(N * N * 2, dtype=np.float32).reshape(N, N, 2)
    tiled, untiled, barrier = per_kernel(lambda a, b: (
        coll.all_to_all_vectored(a, ax, N),
        coll.all_to_all_vectored(b, ax, N, tiled=False),
        coll.tree_barrier(ax)), jnp.asarray(a2a_in), jnp.asarray(a2a_untiled))
    out["a2a/tiled"] = np.asarray(tiled)
    out["a2a/untiled"] = np.asarray(untiled)
    out["barrier"] = np.asarray(barrier)

    dma_mesh = make_mesh((N,), ("x",))
    for name, (chunk, dt) in DMA_CASES.items():
        x = jnp.asarray(_dma_input(name), getattr(jnp, dt))
        out[f"dma/{name}"] = np.asarray(ring_allreduce_dma(dma_mesh, "x", x),
                                        np.float32).reshape(N, chunk)

    def run_ops(name, transport, seg0, prog, *args):
        ctx = ShoalContext(mesh=mesh, axes=ax, transport=transport,
                           segment_words=seg0.shape[1])
        gas = GlobalAddressSpace(ctx)

        def inner(st, *a):
            st = jax.tree.map(lambda v: v[0], st)
            st, extras = prog(ctx, st, *(v[0] for v in a))
            return (jax.tree.map(lambda v: v[None], st),
                    tuple(e[None] for e in extras))

        fn = jax.jit(shard_map(inner, mesh=mesh,
                               in_specs=(spec,) * (1 + len(args)),
                               out_specs=(spec, spec)))
        st, extras = fn(gas.make_global_state(seg0.reshape(-1)),
                        *(jnp.asarray(a) for a in args))
        for f in dataclasses.fields(st):
            out[f"{name}/{f.name}"] = np.asarray(getattr(st, f.name))
        for i, e in enumerate(extras):
            out[f"{name}/extra{i}"] = np.asarray(e)

    for name, (words, pattern, mtu) in HUM.items():
        def hum(ctx, st, p, name=name, pattern=pattern):
            st, recv = humboldt.sendrecv(ctx, st, p, pattern, token=4)
            st = ops.wait_replies(ctx, st, token=4, n=_hum_waits(ctx, name))
            return st, (recv,)
        run_ops(f"hum/{name}", _transport(runtime, mtu),
                np.zeros((N, 64), np.float32), hum, _hum_input(name))

    for name, mtu in MASKED.items():
        seg0, pay = _masked_inputs(name)
        run_ops(f"masked/{name}", _transport(runtime, mtu), seg0,
                lambda ctx, st, p: _masked_prog(ops, ctx, st, p), pay)
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("collectives") / "reference.npz"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ,
               XLA_FLAGS=f"--xla_force_host_platform_device_count={N}",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(repo, "src"))
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           str(path)], env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(path))


def _assert_bits(got, want, what):
    got = got.detach().cpu()
    if got.dtype.is_floating_point:
        got = got.float()
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want),
                                  err_msg=what)


@pytest.mark.parametrize("name", list(COLL))
def test_ring_collectives_match_reference(reference, name):
    import torch

    from repro_torch.core import collectives as coll
    from repro_torch.core.state import ShoalContext

    ctx = ShoalContext(N, device="cpu")
    x = torch.from_numpy(_coll_input(name))
    got = {}
    counts = {}
    for key, fn in (("ar", lambda: coll.ring_all_reduce(ctx, x)),
                    ("rs", lambda: coll.ring_reduce_scatter(ctx, x)),
                    ("bc0", lambda: coll.broadcast_from(ctx, x, root=0)),
                    ("bc5", lambda: coll.broadcast_from(ctx, x, root=5))):
        before = ctx.exchanges
        got[key] = fn()
        counts[key] = ctx.exchanges - before
    before = ctx.exchanges
    got["ag"] = coll.ring_all_gather(ctx, got["rs"])
    counts["ag"] = ctx.exchanges - before
    for key, val in got.items():
        _assert_bits(val, reference[f"coll/{name}/{key}"], f"{name}/{key}")
    assert counts == dict(ar=2 * (N - 1), rs=N - 1, ag=N - 1,
                          bc0=2 * (N - 1), bc5=2 * (N - 1)), counts


def test_all_to_all_and_barrier_match_reference(reference):
    import torch

    from repro_torch.core import collectives as coll
    from repro_torch.core.state import ShoalContext

    ctx = ShoalContext(N, device="cpu")
    a = torch.arange(N * 16 * 3, dtype=torch.int32).reshape(N, 16, 3)
    b = torch.arange(N * N * 2, dtype=torch.float32).reshape(N, N, 2)
    _assert_bits(coll.all_to_all_vectored(ctx, a), reference["a2a/tiled"],
                 "tiled")
    assert ctx.exchanges == 1
    _assert_bits(coll.all_to_all_vectored(ctx, b, tiled=False),
                 reference["a2a/untiled"], "untiled")
    _assert_bits(coll.tree_barrier(ctx), reference["barrier"], "barrier")
    assert ctx.exchanges == 2
    with pytest.raises(ValueError, match="split"):
        coll.all_to_all_vectored(ctx, a[:, :15])


@pytest.mark.parametrize("name", list(DMA_CASES))
def test_ring_allreduce_dma_matches_pallas_interpret(reference, name):
    """The plain version adds in the TPU kernel's ring order and rounds
    to the type after every add, so it equals the Pallas kernel bitwise
    in float32 and in bfloat16."""
    import torch

    from repro_torch.kernels.gascore_dma import ring_allreduce_dma

    chunk, dt = DMA_CASES[name]
    x = torch.from_numpy(_dma_input(name).reshape(N, chunk)).to(
        getattr(torch, dt))
    _assert_bits(ring_allreduce_dma(x), reference[f"dma/{name}"], name)


def _port_ops(name, transport, seg0, prog, *args):
    import torch

    from repro_torch.core.address_space import GlobalAddressSpace
    from repro_torch.core.state import ShoalContext, state_to_numpy

    ctx = ShoalContext(N, transport, seg0.shape[1], device="cpu")
    st = GlobalAddressSpace(ctx).make_global_state(seg0.reshape(-1))
    st, extras = prog(ctx, st, *(torch.from_numpy(a) for a in args))
    return ctx, state_to_numpy(st), extras


def _assert_ops(reference, prefix, state, extras):
    for f, arr in state.items():
        np.testing.assert_array_equal(_bits(arr),
                                      _bits(reference[f"{prefix}/{f}"]),
                                      err_msg=f"{prefix}: {f}")
    for i, e in enumerate(extras):
        _assert_bits(e, reference[f"{prefix}/extra{i}"],
                     f"{prefix}: extra{i}")


@pytest.mark.parametrize("name", list(HUM))
def test_humboldt_sendrecv_matches_reference(reference, name):
    from repro_torch import runtime
    from repro_torch.core import humboldt, ops

    words, pattern, mtu = HUM[name]

    def hum(ctx, st, p):
        st, recv = humboldt.sendrecv(ctx, st, p, pattern, token=4)
        st = ops.wait_replies(ctx, st, token=4, n=_hum_waits(ctx, name))
        return st, (recv,)

    ctx, state, extras = _port_ops(name, _transport(runtime, mtu),
                                   np.zeros((N, 64), np.float32), hum,
                                   _hum_input(name))
    _assert_ops(reference, f"hum/{name}", state, extras)
    segments = -(-words // (mtu // 4))
    assert ctx.exchanges == humboldt.HOPS_PER_MESSAGE * segments
    assert not state["error"].any() and not state["credits"].any()


@pytest.mark.parametrize("name", list(MASKED))
def test_masked_lanes_match_reference_in_ops(reference, name):
    """NaN, +-inf and negatives in the segment and in FIFO payloads go
    through put_medium / get_medium as the reference carries them."""
    from repro_torch import runtime
    from repro_torch.core import ops

    seg0, pay = _masked_inputs(name)
    _, state, extras = _port_ops(
        name, _transport(runtime, MASKED[name]), seg0,
        lambda ctx, st, p: _masked_prog(ops, ctx, st, p), pay)
    _assert_ops(reference, f"masked/{name}", state, extras)


def test_masked_lanes_match_reference_in_gascore_stages():
    """Egress, get service and Medium ingress on 8 kernels against the
    reference's stages, evaluated op by op, bitwise: a float lane past
    ``nwords`` is the word there times 0 (NaN for NaN or +-inf, -0.0 for
    a negative).  XLA rewrites ``x * convert(lane_mask)`` into a select
    when it compiles a stage (under ``jit``, or in the ``lax.scan`` of a
    multi-row ``ingress_medium_batch``), which zeroes those lanes; so the
    batched Medium ingress is held to the reference's row function,
    ``ingress_medium``, row by row."""
    import jax.numpy as jnp
    import torch

    from repro.core import am as jam, gascore as jgc
    from repro.core.state import PgasState as JaxState
    from repro.core.state import ShoalContext as JaxCtx
    from repro.runtime.topology import make_cpu_mesh
    from repro_torch.core import am as tam, gascore as tgc
    from repro_torch.core.state import (FIELDS, ShoalContext,
                                        state_from_numpy)

    S, W = 48, 16
    rng = np.random.default_rng(7)
    seg = _poison(rng.standard_normal((N, S)), rng)
    proto = JaxState.make(S, jnp.float32)
    d = {f: np.stack([np.asarray(getattr(proto, f))] * N) for f in FIELDS}
    d["segment"] = seg
    st = state_from_numpy(d, device="cpu")
    jst = [JaxState(**{f: jnp.asarray(d[f][k]) for f in FIELDS})
           for k in range(N)]
    jctx = JaxCtx(mesh=make_cpu_mesh(1, ("kernel",)), axes=("kernel",),
                  segment_words=S)
    ctx = ShoalContext(N, segment_words=S, device="cpu")
    long_t, med = jam.make_type(jam.LONG), jam.make_type(jam.MEDIUM)
    get = jam.make_type(jam.MEDIUM, get=True)

    def rows(fields):
        return np.stack([np.stack([np.asarray(jam.encode(**f)) for f in r])
                         for r in fields]).astype(np.int32)

    eg = rows([[dict(type=long_t, nwords=k + 1, src_addr=3 * k),
                dict(type=long_t, nwords=(5 * k) % W, src_addr=S - k)]
               for k in range(N)])
    fifo = _poison(rng.standard_normal((N, 2 * W - 5)), rng)
    for src in (None, fifo):
        got = tgc.egress_batch(ctx, st, torch.from_numpy(eg),
                               None if src is None else torch.from_numpy(src),
                               W)
        want = [jgc.egress_batch(jctx, jst[k], jnp.asarray(eg[k]),
                                 None if src is None else jnp.asarray(src[k]),
                                 W) for k in range(N)]
        _assert_bits(got, np.stack(want),
                     f"egress_batch fifo={src is not None}")
    one = tgc.egress(ctx, st, tam.decode(torch.from_numpy(eg[:, 0])), None, W)
    _assert_bits(one, np.stack([jgc.egress(
        jctx, jst[k], jam.decode(jnp.asarray(eg[k, 0])), None, W)
        for k in range(N)]), "egress")

    sg = rows([[dict(type=get if k % 3 else long_t, nwords=(3 * k) % W,
                     src_addr=4 * k, src=k, dst=(k + 1) % N, token=2)]
               for k in range(N)])
    _, resp, data = tgc.serve_get_batch(ctx, st, torch.from_numpy(sg), W)
    want = [jgc.serve_get_batch(jctx, jst[k], jnp.asarray(sg[k]), W)
            for k in range(N)]
    _assert_bits(resp, np.stack([np.asarray(w[1]) for w in want]), "resp")
    _assert_bits(data, np.stack([np.asarray(w[2]) for w in want]), "data")

    mr = rows([[dict(type=med if k % 4 else long_t, nwords=(7 * k) % W),
                dict(type=med, nwords=k)] for k in range(N)])
    pay = _poison(rng.standard_normal((N, 2, W)), rng)
    _, got = tgc.ingress_medium_batch(st, torch.from_numpy(mr),
                                      torch.from_numpy(pay), W)
    _assert_bits(got, np.stack([np.concatenate([np.asarray(
        jgc.ingress_medium(jst[k], jam.decode(jnp.asarray(mr[k, r])),
                           jnp.asarray(pay[k, r]), W)[1]) for r in range(2)])
        for k in range(N)]), "ingress_medium_batch")
    _, got = tgc.ingress_medium(st, tam.decode(torch.from_numpy(mr[:, 0])),
                                torch.from_numpy(pay[:, 0]), W)
    _assert_bits(got, np.stack([np.asarray(jgc.ingress_medium(
        jst[k], jam.decode(jnp.asarray(mr[k, 0])), jnp.asarray(pay[k, 0]),
        W)[1]) for k in range(N)]), "ingress_medium")


def test_one_kernel_is_the_identity_with_no_exchange():
    """At n = 1 every collective returns its input (the reference's early
    returns) and makes no exchange; the RDMA ring is the identity."""
    import jax.numpy as jnp
    import torch

    from repro.core import collectives as jcoll
    from repro_torch.core import collectives as coll
    from repro_torch.core.state import ShoalContext
    from repro_torch.kernels.gascore_dma import ring_allreduce_dma

    ctx = ShoalContext(1, device="cpu")
    x = np.random.default_rng(9).standard_normal((1, 4, 5)).astype(
        np.float32)
    t, j = torch.from_numpy(x), jnp.asarray(x[0])
    ax = ("kernel",)
    pairs = [(coll.ring_all_reduce(ctx, t), jcoll.ring_all_reduce(j, ax, 1)),
             (coll.ring_reduce_scatter(ctx, t),
              jcoll.ring_reduce_scatter(j, ax, 1)),
             (coll.ring_all_gather(ctx, t), jcoll.ring_all_gather(j, ax, 1)),
             (coll.broadcast_from(ctx, t, root=0),
              jcoll.broadcast_from(j, ax, 1)),
             (coll.all_to_all_vectored(ctx, t), j)]
    for got, want in pairs:
        _assert_bits(got, np.asarray(want)[None], "n=1")
    assert coll.tree_barrier(ctx).tolist() == [1]
    assert ctx.exchanges == 0
    assert not any(ctx.collectives.values())
    _assert_bits(ring_allreduce_dma(t[:, 0]), x[:, 0], "dma n=1")


def test_each_collective_call_counts_once_by_kind():
    """``ctx.collectives`` adds one per call to its kind, whatever the
    call's traversals (``ctx.exchanges`` keeps counting those): the
    compiled program's one op per collective.  ``broadcast_from`` is
    permutes only."""
    import torch

    from repro_torch.core import collectives as coll
    from repro_torch.core.state import COLLECTIVE_KINDS, ShoalContext

    ctx = ShoalContext(N, device="cpu")
    x = torch.ones(N, N, 3)
    for fn, kind, exchanges in (
            (coll.ring_all_reduce, "all_reduce", 2 * (N - 1)),
            (coll.ring_reduce_scatter, "reduce_scatter", N - 1),
            (coll.ring_all_gather, "all_gather", N - 1),
            (coll.all_to_all_vectored, "all_to_all", 1),
            (lambda c, _: coll.tree_barrier(c), "all_reduce", 0),
            (coll.broadcast_from, None, 2 * (N - 1))):
        before, calls = ctx.exchanges, dict(ctx.collectives)
        fn(ctx, x)
        assert ctx.exchanges - before == exchanges, kind
        assert {k: ctx.collectives[k] - calls[k] for k in COLLECTIVE_KINDS} \
            == {k: int(k == kind) for k in COLLECTIVE_KINDS}, kind


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_ring_plain_versions_hold_the_sum(dtype):
    """The plain schedules at K that are not 8, sizes that do not split
    into K chunks: every kernel ends with the same sum, the float64 sum
    within the reference's tolerance (float32 1e-5, bfloat16 5e-2) and
    int32 exactly."""
    import torch

    from repro_torch.core import collectives as coll
    from repro_torch.core.state import ShoalContext
    from repro_torch.kernels.gascore_dma import ring_allreduce_dma

    tol = {"float32": 1e-5, "bfloat16": 5e-2, "int32": 0}[dtype]
    for K, size in ((2, 3), (3, 10), (5, 7), (7, 50)):
        rng = np.random.default_rng(K)
        x = torch.from_numpy(rng.integers(-127, 128, (K, size))).to(
            getattr(torch, dtype))
        want = x.double().sum(0)
        ctx = ShoalContext(K, device="cpu")
        for got in (coll.ring_all_reduce(ctx, x), ring_allreduce_dma(x)):
            err = (got.double() - want).abs().max().item()
            assert err <= tol * want.abs().max().item(), (K, size, err)
        assert ctx.exchanges == 2 * (K - 1)
        ag = coll.ring_all_gather(ctx, coll.ring_reduce_scatter(ctx, x))
        assert torch.equal(ag.reshape(K, -1)[:, :size],
                           coll.ring_all_reduce(ctx, x))


def test_ring_tile_plan_refuses_what_the_kernel_cannot_hold():
    import torch

    from repro_torch.kernels.gascore_dma import tile_plan

    assert tile_plan(8, 8_192_000, torch.float32, "all_reduce") == (32, 4)
    assert tile_plan(8, 37, torch.float32, "all_reduce") == (32, 1)
    assert tile_plan(8, 64, torch.bfloat16, "dma") == (32, 8)
    assert tile_plan(1024, 4, torch.int32, "dma") == (1, 4)
    for K, schedule in ((1025, "dma"), (200, "all_reduce")):
        with pytest.raises(ValueError, match="does not fit"):
            tile_plan(K, 4096, torch.float32, schedule)


# -- the collectives' backward -------------------------------------------------

GRAD_OPS = ("reduce_scatter", "all_gather", "all_reduce", "all_to_all",
            "broadcast")
GRAD_KS = (2, 3, 8)
ADJOINT_KIND = {"reduce_scatter": "all_gather", "all_gather": "reduce_scatter",
                "all_reduce": "all_reduce", "all_to_all": "all_to_all",
                "broadcast": "all_reduce"}


def _padded(g, K):
    """``g (K, ...)`` flat and zero-padded to ``(K, K, ceil(size/K))``."""
    import torch

    flat = g.reshape(K, -1)
    c = -(-flat.shape[1] // K)
    flat = torch.cat([flat, flat.new_zeros(K, c * K - flat.shape[1])], 1)
    return flat.reshape(K, K, c)


def _plain_adjoint(op, g, x):
    """The cotangent of ``x`` from the plain ring schedules, written out
    on their own: what the autograd edge must give bitwise."""
    from repro_torch.kernels.gascore_dma.ref import (ALL_REDUCE,
                                                     ring_all_gather_ref,
                                                     ring_collective_ref,
                                                     ring_reduce_scatter_ref)

    K = g.shape[0]
    size = x[0].numel()
    if op == "reduce_scatter":
        return ring_all_gather_ref(g).reshape(K, -1)[:, :size].reshape(
            x.shape)
    if op == "all_gather":
        return ring_reduce_scatter_ref(g).reshape(x.shape)
    if op == "all_to_all":
        m = g.shape[1]
        return g.reshape(K, K, m // K, *g.shape[2:]).transpose(0, 1).reshape(
            g.shape)
    full = ring_collective_ref(_padded(g, K), ALL_REDUCE).reshape(K, -1)
    if op == "all_reduce":
        return full[:, :size].reshape(x.shape)
    return full[0, :x.numel()].reshape(x.shape)         # broadcast


def _grad_call(op, ctx, x):
    from repro_torch.core import collectives as coll

    return {"reduce_scatter": coll.ring_reduce_scatter,
            "all_gather": coll.ring_all_gather,
            "all_reduce": coll.ring_all_reduce,
            "all_to_all": coll.all_to_all_vectored,
            "broadcast": coll.broadcast_to_kernels}[op](ctx, x)


@pytest.mark.parametrize("K", GRAD_KS)
@pytest.mark.parametrize("op", GRAD_OPS)
def test_collective_backward_is_its_plain_adjoint(op, K):
    """Each collective's backward, at K kernels and 35 words a kernel (a
    ragged split: the reduce-scatter's and all-reduce's pad is cut off
    again), against its adjoint from the plain schedules, bitwise; the
    backward counts what a forward call of the adjoint's kind counts."""
    import torch

    from repro_torch.core.state import COLLECTIVE_KINDS, ShoalContext

    rng = np.random.default_rng(K)
    shape = {"all_to_all": (K, 2 * K, 3), "broadcast": (5, 7)}.get(
        op, (K, 5, 7))
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    x.requires_grad_()
    ctx = ShoalContext(K, device="cpu")
    y = _grad_call(op, ctx, x)
    g = torch.from_numpy(rng.standard_normal(tuple(y.shape)).astype(
        np.float32))
    g.reshape(-1)[::5] = 0.0
    fwd = (ctx.exchanges, dict(ctx.collectives))
    (dx,) = torch.autograd.grad(y, x, g)
    _assert_bits(dx, _plain_adjoint(op, g, x.detach()).numpy(), op)
    each = {"reduce_scatter": K - 1, "all_gather": K - 1,
            "all_reduce": 2 * (K - 1), "all_to_all": 1}
    kind = ADJOINT_KIND[op]
    assert ctx.exchanges - fwd[0] == each[kind]
    if op != "broadcast":       # a broadcast's forward makes no exchange
        assert fwd[0] == each[op]
    assert {k: ctx.collectives[k] - fwd[1][k] for k in COLLECTIVE_KINDS} \
        == {k: int(k == kind) for k in COLLECTIVE_KINDS}


def test_ring_adjoints_reduce_in_float32():
    """A bfloat16 input's cotangent goes through the adjoint ring in
    float32 and comes back in bfloat16; without an input that requires
    grad (or under ``no_grad``) a call builds no autograd edge and gives
    the same words."""
    import torch

    from repro_torch.core import collectives as coll
    from repro_torch.core.state import ShoalContext

    K = 3
    ctx = ShoalContext(K, device="cpu")
    rng = np.random.default_rng(5)
    for op in ("reduce_scatter", "all_gather", "all_reduce", "broadcast"):
        shape = (5, 7) if op == "broadcast" else (K, 5, 7)
        x = torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(torch.bfloat16).requires_grad_()
        y = _grad_call(op, ctx, x)
        g = torch.from_numpy(rng.standard_normal(tuple(y.shape)).astype(
            np.float32)).to(y.dtype)
        (dx,) = torch.autograd.grad(y, x, g)
        assert dx.dtype == torch.bfloat16
        want = _plain_adjoint(op, g.float(), x.detach()).to(torch.bfloat16)
        _assert_bits(dx, want.float().numpy(), op)
        with torch.no_grad():
            plain = _grad_call(op, ctx, x)
        assert plain.grad_fn is None and torch.equal(plain, y.detach())
    assert coll.ring_all_reduce(ctx, torch.ones(K, 4)).grad_fn is None


if __name__ == "__main__":
    _run_reference(sys.argv[1])
