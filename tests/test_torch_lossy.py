"""The port's lossy-transport layer (fault draws, CRC, dedup ledger,
reliable put) against the JAX package's.

The JAX package's reliable put does not run live on 8 devices: its
dedup-gated ingress scans inside ``shard_map`` and the scan refuses its
own carry (the scan-carry caveat of ROADMAP §3 that fails
``test_faults::test_fault_semantics_multidevice``).  Its pieces run,
so the reference here is the reliable put replayed op by op from them,
in one subprocess with 8 emulated CPU devices (``python
tests/test_torch_lossy.py OUT.npz``): the sealed, faulted exchange
(``ops._lossy_exchange``) live under ``shard_map``, the dedup-gated
ingress (``gascore.ingress_reliable_stack``) per kernel on one device,
the round loop of ``ops._put_long_reliable`` between them.  The port
runs the same put with the JAX package's own fault draws fed in through
``FaultModel(draws=...)`` (torch cannot reproduce threefry), and every
PgasState field must be equal (tolerance: none), at the reference's
exchange count (two per round when acked, every round run).

In process, on one device: ``faults.deliver`` bitwise against the
reference's given its draws, every single-bit flip caught by the CRC,
``ingress_reliable_stack`` on hand-built stacks against the reference
(and, under hypothesis, against a numpy replay of
``src/repro/core/gascore.py:477-515``), the contracts of
``tests/fault_checks.py`` replayed on the port with both draw sources,
and ``benchmarks/bench_faults.py``'s configuration held to
``BENCH_comm.json``'s recorded tx_words and retransmit means.
"""

import dataclasses
import functools
import json
import os
import sys

import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, strategies as st

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_reference import N, REPO, run_reference, spmd_run  # noqa: E402

RING = [(i, (i + 1) % N) for i in range(N)]
EVEN = [(i, i + 1) for i in range(0, N, 2)]
MTU = 16                # bytes: 4 payload words per packet
PAY = 16                # a 16-word put = 4 segments
SEG = 64


def _pods(runtime):
    """Kernels 0-3 and 4-7 are two pods: links inside a pod are ICI
    (lossless), links between them DCN."""
    def link_of(s, d, L=runtime.LinkClass):
        if s == d:
            return L.LOCAL
        return L.DCN if s // 4 != d // 4 else L.ICI
    return link_of


# -- the reliable-put cases: (fault model, transport, program) --------------

@dataclasses.dataclass(frozen=True)
class Put:
    drop: float = 0.0
    dup: float = 0.0
    corrupt: float = 0.0
    seed: int = 7
    acked: bool = True
    dedup: bool = True
    handler: str = "H_WRITE"
    ones: bool = False            # payload of ones (else (i + 1) * (k + 1))
    max_retries: int = 4
    pods: bool = False            # only inter-pod links are lossy
    pattern: tuple = tuple(RING)


PUTS = {
    # benchmarks/bench_faults.py: the 0% row still runs the reliable path
    "bench-0pct": Put(drop=1e-12),
    "bench-1pct": Put(drop=0.01),
    "bench-5pct": Put(drop=0.05),
    "corrupt": Put(drop=0.05, dup=0.02, corrupt=0.02, seed=3),
    "dup-heavy": Put(dup=0.5, seed=5),
    "dedup-off-add": Put(dup=0.5, seed=5, dedup=False, handler="H_ADD",
                         ones=True),
    "dedup-on-add": Put(dup=0.5, seed=5, handler="H_ADD", ones=True),
    "exhausted": Put(drop=1.0, seed=0),
    "async": Put(drop=0.3, seed=9, acked=False),
    "retries-1": Put(drop=0.3, corrupt=0.1, seed=13, max_retries=1),
    "pods": Put(drop=0.3, dup=0.2, corrupt=0.2, seed=21, pods=True),
    "partial-pattern": Put(drop=0.2, dup=0.2, seed=4, pattern=tuple(EVEN)),
}


def _pay(case):
    if case.ones:
        return np.ones((N, PAY), np.float32)
    return ((np.arange(PAY, dtype=np.float32) + 1)[None]
            * (np.arange(N, dtype=np.float32) + 1)[:, None])


def _lossy(runtime, model, case, **kw):
    return runtime.LossyTransport(
        faults=model, acked=case.acked, max_packet_bytes=MTU,
        max_retries=case.max_retries,
        **({"link_of": _pods(runtime)} if case.pods else {}), **kw)


# -- exchange cases: the sealed, faulted traversal alone --------------------

EXCHANGES = {
    "ring-all-faults": dict(drop=0.2, dup=0.3, corrupt=0.3, seed=5,
                            pattern=RING, rnd=0, direction=0),
    "ring-reply-round3": dict(drop=0.1, dup=0.4, corrupt=0.4, seed=8,
                              pattern=[(d, s) for s, d in RING], rnd=3,
                              direction=1),
    "even-partial": dict(drop=0.3, dup=0.3, corrupt=0.2, seed=2,
                         pattern=EVEN, rnd=1, direction=0),
    "pods": dict(drop=0.5, dup=0.5, corrupt=0.5, seed=6, pattern=RING,
                 rnd=0, direction=0, pods=True),
}


def _exchange_inputs(name):
    """A (N, 3, HDR + 6) int32 packet stack with a NOP row on odd
    kernels, and per-kernel token and epoch."""
    rng = np.random.default_rng(sorted(EXCHANGES).index(name) + 900)
    pkt = rng.integers(-2 ** 31, 2 ** 31, (N, 3, 16 + 6),
                       dtype=np.int64).astype(np.int32)
    pkt[:, :, 0] = 3 | (1 << 5)              # live FIFO Long rows
    pkt[1::2, 1] = 0                         # NOP rows never fault
    token = rng.integers(0, 16, N).astype(np.int32)
    epoch = rng.integers(1, 5, N).astype(np.int32)
    return pkt, token, epoch


# -- the reference, op by op --------------------------------------------------

def _ref_reliable_put(mesh, mesh1, case):
    """The JAX package's ``put_long`` on a lossy transport: its header
    plan and egress, then ``_put_long_reliable``'s rounds with every
    exchange live under ``shard_map`` and every ingress on one device
    per kernel; then ``wait_replies(timeout=True)``.  Returns the
    global state and the collective-permutes of every step."""
    import jax
    import jax.numpy as jnp

    from repro import runtime
    from repro.core import am, gascore as gc, handlers as hd, ops
    from repro.core import faults as flt
    from repro.core.address_space import GlobalAddressSpace
    from repro.core.state import (ERR_RETRY_EXHAUSTED, ShoalContext)

    model = flt.FaultModel(drop=case.drop, dup=case.dup,
                           corrupt=case.corrupt, seed=case.seed)
    transport = _lossy(runtime, model, case)
    pattern = list(case.pattern)
    ctx = ShoalContext(mesh=mesh, axes=("kernel",), transport=transport,
                       segment_words=SEG)
    ctx1 = dataclasses.replace(ctx, mesh=mesh1)
    st = GlobalAddressSpace(ctx).make_global_state()
    handler, token = getattr(hd, case.handler), 1
    segs = ops._segments(PAY, transport.max_packet_words)
    nseg, W = len(segs), segs[0][1]
    offs = jnp.asarray([o for o, _ in segs], jnp.int32)
    ws = jnp.asarray([w for _, w in segs], jnp.int32)
    acked = transport.acked
    wire = am.wire_words(jnp.float32, PAY) + nseg * am.HDR_WORDS
    cps = 0

    def plan(st, p):
        hdrs = am.encode_batch(
            nseg, type=ops._seg_types(am.LONG, nseg, asynchronous=not acked,
                                      fifo=True),
            src=ctx.my_id(), dst=ops._dst_of(ctx, pattern), nwords=ws,
            dst_addr=10 + offs, handler=handler, token=token, seq=offs)
        hdrs = ops._mask_nonparticipants(ctx, pattern, hdrs)
        buf = gc.egress_batch(ctx, st, hdrs, p, W)
        tok_c = jnp.clip(jnp.asarray(token, jnp.int32), 0,
                         hd.NUM_TOKENS - 1)
        sender = ops._is_sender(ctx, pattern)
        epoch = st.send_epoch[tok_c] + 1
        st = gc.dataclasses_replace(st, send_epoch=st.send_epoch.at[
            tok_c].add(sender.astype(jnp.int32)))
        hdrs = hdrs.at[:, ops._I_EPOCH].set(
            jnp.where(hdrs[:, ops._I_TYPE] != 0, epoch, 0))
        return st, (hdrs, buf, epoch, sender)

    st, (hdrs, buf, epoch, pending), c, _ = spmd_run(
        mesh, plan, st, jnp.asarray(_pay(case)))
    cps += c
    sender = pending
    attempts = 1 + (transport.max_retries if acked else 0)
    ingress = jax.jit(functools.partial(
        gc.ingress_reliable_stack, ctx1, packet_words=W, dedup=case.dedup))
    # the round rides as an argument, so each step compiles once
    def data(st, hdrs, buf, pending, epoch, rnd):
        st = gc.dataclasses_replace(
            st, retransmits=st.retransmits
            + (pending & (rnd > 0)).astype(jnp.int32))
        rows = jnp.where(pending, hdrs, 0)
        pay = jnp.where(pending, buf, jnp.zeros_like(buf))
        st = gc.dataclasses_replace(
            st, tx_words=st.tx_words + jnp.where(pending, wire, 0))
        st, hdr_r, pay_r = ops._lossy_exchange(
            ctx, st, pattern, am.pack_packet(rows, pay), buf.dtype,
            token=token, epoch=epoch, rnd=rnd, direction=flt.DIR_DATA)
        return st, (hdr_r, pay_r)

    def ack(st, ack_hdr, pending, epoch, rnd):
        st = gc.dataclasses_replace(st, tx_words=st.tx_words + jnp.where(
            ack_hdr[ops._I_TYPE] != 0, am.HDR_WORDS, 0))
        st, rep_r, _ = ops._lossy_exchange(
            ctx, st, ops._reverse(pattern), ack_hdr[None, :], jnp.int32,
            token=token, epoch=epoch, rnd=rnd, direction=flt.DIR_REPLY)
        t_col = rep_r[:, ops._I_TYPE]
        got = jnp.any(((t_col & am._CLASS_MASK) == am.SHORT)
                      & ((t_col & am.FLAG_REPLY) != 0)
                      & (rep_r[:, ops._I_TOKEN] == token))
        return st, (pending & ~got,)

    data_c = ack_c = None
    for rnd in range(attempts):
        rnds = jnp.full((N,), rnd, jnp.int32)
        st, (hdr_r, pay_r), c, data_c = spmd_run(
            mesh, data, st, hdrs, buf, pending, epoch, rnds,
            compiled=data_c)
        cps += c
        outs = [ingress(jax.tree.map(lambda x, k=k: x[k], st), hdr_r[k],
                        pay_r[k]) for k in range(N)]
        st = jax.tree.map(lambda *xs: jnp.stack(xs),
                          *[o[0] for o in outs])
        ack_hdr = jnp.stack([o[1] for o in outs])
        if not acked:
            break
        st, (pending,), c, ack_c = spmd_run(
            mesh, ack, st, ack_hdr, pending, epoch, rnds, compiled=ack_c)
        cps += c

    def finish(st, sender, pending):
        if acked:
            st = gc.dataclasses_replace(
                st, credits=st.credits.at[token].add(
                    (sender & ~pending).astype(jnp.int32)),
                error=st.error | jnp.where(pending, ERR_RETRY_EXHAUSTED, 0)
                .astype(jnp.int32))
        return ops.wait_replies(ctx, st, token, 1, timeout=True), ()

    st, _, c, _ = spmd_run(mesh, finish, st, sender, pending)
    return st, cps + c


def _run_reference(out_path):
    import jax.numpy as jnp

    from repro import runtime
    from repro.core import ops
    from repro.core import faults as flt
    from repro.core.address_space import GlobalAddressSpace
    from repro.core.state import ShoalContext

    mesh = runtime.make_cpu_mesh(N, ("kernel",))
    mesh1 = runtime.make_cpu_mesh(1, ("kernel",))
    out = {}
    for name, case in PUTS.items():
        st, cps = _ref_reliable_put(mesh, mesh1, case)
        for f in dataclasses.fields(st):
            out[f"put/{name}/{f.name}"] = np.asarray(getattr(st, f.name))
        out[f"put/{name}/cps"] = np.asarray(cps)
    for name, ex in EXCHANGES.items():
        model = flt.FaultModel(drop=ex["drop"], dup=ex["dup"],
                               corrupt=ex["corrupt"], seed=ex["seed"])
        kw = {"link_of": _pods(runtime)} if ex.get("pods") else {}
        ctx = ShoalContext(mesh=mesh, axes=("kernel",), segment_words=SEG,
                           transport=runtime.LossyTransport(faults=model,
                                                            **kw))
        pkt, token, epoch = _exchange_inputs(name)

        def fn(st, pkt, token, epoch, ex=ex, ctx=ctx):
            st, h, p = ops._lossy_exchange(
                ctx, st, ex["pattern"], pkt, jnp.float32, token=token,
                epoch=epoch, rnd=ex["rnd"], direction=ex["direction"])
            return st, (h, p)

        st, (h, p), cps, _ = spmd_run(
            mesh, fn, GlobalAddressSpace(ctx).make_global_state(),
            jnp.asarray(pkt), jnp.asarray(token), jnp.asarray(epoch))
        out[f"exchange/{name}/error"] = np.asarray(st.error)
        out[f"exchange/{name}/hdr"] = np.asarray(h)
        out[f"exchange/{name}/pay"] = np.asarray(p).view(np.int32)
        out[f"exchange/{name}/cps"] = np.asarray(cps)
    # the lossless oracle of tests/fault_checks.py
    ctx = ShoalContext(mesh=mesh, axes=("kernel",), segment_words=SEG,
                       transport=dataclasses.replace(
                           runtime.TCP, max_packet_bytes=MTU))

    def oracle(st, p):
        st = ops.put_long(ctx, st, p, RING, dst_addr=10, token=1)
        return ops.wait_replies(ctx, st, 1, 1), ()

    st, _, _, _ = spmd_run(mesh, oracle,
                        GlobalAddressSpace(ctx).make_global_state(),
                        jnp.asarray(_pay(Put())))
    out["oracle/segment"] = np.asarray(st.segment)
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(__file__,
                         tmp_path_factory.mktemp("lossy") / "ref.npz",
                         timeout=1200)


# -- the JAX package's draws, for the port's FaultModel(draws=...) -----------

@functools.lru_cache(maxsize=None)
def _jax_draws(seed):
    """A draw source giving, for every receiver, exactly the draws the
    JAX package's ``faults.inject`` makes from ``fault_key(seed,
    receiver, token, epoch, rnd, direction)``."""
    import jax

    from repro.core import faults as jflt
    from repro_torch.core.faults import Draws

    jmodel = jflt.FaultModel(seed=seed)

    def one(receiver, token, epoch, rnd, direction, nseg, width):
        key = jflt.fault_key(jmodel, receiver, token, epoch, rnd, direction)
        kd, ku, kc, kb = jax.random.split(key, 4)
        return (jax.random.uniform(kd, (nseg,)),
                jax.random.uniform(ku, (nseg,)),
                jax.random.uniform(kc, (nseg,)),
                jax.random.randint(kb, (nseg,), 0, width * 32))

    batched = jax.jit(jax.vmap(one, in_axes=(0, 0, 0, None, None, None,
                                             None)),
                      static_argnums=(5, 6))

    def draws(receiver, token, epoch, rnd, direction, nseg, width):
        K = receiver.shape[0]

        def col(x):
            return np.asarray(torch.as_tensor(x).expand(K).cpu(), np.int32)

        outs = batched(col(receiver), col(token), col(epoch),
                       np.int32(rnd), np.int32(direction), int(nseg),
                       int(width))
        dev = receiver.device
        u = [torch.from_numpy(np.array(o)).to(dev) for o in outs[:3]]
        bit = torch.from_numpy(np.array(outs[3], np.int64)).to(dev)
        return Draws(u[0], u[1], u[2], bit)

    return draws


def _port_model(case, source):
    from repro_torch.core.faults import FaultModel

    return FaultModel(drop=case.drop, dup=case.dup, corrupt=case.corrupt,
                      seed=case.seed,
                      draws=_jax_draws(case.seed) if source == "reference"
                      else None)


def _port_put(case, source="reference", seed=None):
    """The port's ``put_long`` + ``wait_replies(timeout=True)`` of a
    case; returns ``(ctx, state)``."""
    from repro_torch import runtime
    from repro_torch.core import handlers as hd, ops
    from repro_torch.core.state import ShoalContext

    if seed is not None:
        case = dataclasses.replace(case, seed=seed)
    ctx = ShoalContext(N, _lossy(runtime, _port_model(case, source), case),
                       SEG, device="cpu")
    st = ops.put_long(ctx, ctx.make_state(), torch.from_numpy(_pay(case)),
                      list(case.pattern), dst_addr=10, token=1,
                      handler=getattr(hd, case.handler), dedup=case.dedup,
                      asynchronous=not case.acked)
    return ctx, ops.wait_replies(ctx, st, 1, 1, timeout=True)


@pytest.mark.parametrize("name", list(PUTS))
def test_reliable_put_matches_reference(reference, name):
    from repro_torch.core.state import state_to_numpy

    ctx, st = _port_put(PUTS[name])
    for f, arr in state_to_numpy(st).items():
        np.testing.assert_array_equal(arr, reference[f"put/{name}/{f}"],
                                      err_msg=f"{name}: {f}")
    assert ctx.exchanges == int(reference[f"put/{name}/cps"]), \
        (name, ctx.exchanges, int(reference[f"put/{name}/cps"]))
    attempts = 1 + (PUTS[name].max_retries if PUTS[name].acked else 0)
    assert ctx.exchanges == attempts * (2 if PUTS[name].acked else 1)


@pytest.mark.parametrize("name", list(EXCHANGES))
def test_lossy_exchange_matches_reference(reference, name):
    from repro_torch import runtime
    from repro_torch.core import ops
    from repro_torch.core.faults import FaultModel
    from repro_torch.core.state import ShoalContext

    ex = EXCHANGES[name]
    model = FaultModel(drop=ex["drop"], dup=ex["dup"], corrupt=ex["corrupt"],
                       seed=ex["seed"], draws=_jax_draws(ex["seed"]))
    kw = {"link_of": _pods(runtime)} if ex.get("pods") else {}
    ctx = ShoalContext(N, runtime.LossyTransport(faults=model, **kw), SEG,
                       device="cpu")
    pkt, token, epoch = _exchange_inputs(name)
    st, h, p = ops._lossy_exchange(
        ctx, ctx.make_state(), ex["pattern"], torch.from_numpy(pkt),
        torch.float32, token=torch.from_numpy(token),
        epoch=torch.from_numpy(epoch), rnd=ex["rnd"],
        direction=ex["direction"])
    np.testing.assert_array_equal(st.error.numpy(),
                                  reference[f"exchange/{name}/error"])
    np.testing.assert_array_equal(h.numpy(), reference[f"exchange/{name}/hdr"])
    np.testing.assert_array_equal(p.view(torch.int32).numpy(),
                                  reference[f"exchange/{name}/pay"])
    assert ctx.exchanges == int(reference[f"exchange/{name}/cps"]) == 1


# -- bench_faults.py's configuration, held to the recorded targets ----------

def test_bench_faults_config_gives_recorded_targets(reference):
    """With the reference's draws, the reliable put on
    ``benchmarks/bench_faults.py``'s configuration (8 kernels, a
    16-word acked put over 16-byte packets, seed 7) gives
    ``BENCH_comm.json``'s tx_words and mean retransmits at 0 / 1 / 5 %
    drop, delivers bit-identical to the lossless oracle, drains the
    ledger and exhausts nothing."""
    from repro_torch.core.state import ERR_RETRY_EXHAUSTED

    with open(os.path.join(REPO, "BENCH_comm.json")) as f:
        rec = json.load(f)["current"]["faults"]
    for pct in ("0", "1", "5"):
        _, st = _port_put(PUTS[f"bench-{pct}pct"])
        tx = int(st.tx_words.sum())
        want_tx = rec[f"faults/goodput/{pct}pct"]["derived"]
        assert want_tx == f"tx_words={tx}", (pct, tx, want_tx)
        rounds = float(st.retransmits.float().mean())
        assert rounds == rec[f"faults/retransmit-rounds/{pct}pct"]["value"]
        ok = (np.array_equal(st.segment.numpy(), reference["oracle/segment"])
              and bool((st.dedup_seen == 0).all())
              and not bool((st.error & ERR_RETRY_EXHAUSTED).any()))
        assert float(ok) == rec[f"faults/delivered-ok/{pct}pct"]["value"]


# -- tests/fault_checks.py's contracts, replayed on the port -----------------

SOURCES = ["hash", "reference"]


@pytest.mark.parametrize("source", SOURCES)
def test_contract_delivers_under_loss(reference, source):
    seen_retry = False
    for seed in (7, 11, 19, 23):
        _, st = _port_put(PUTS["bench-1pct"], source, seed=seed)
        np.testing.assert_array_equal(st.segment.numpy(),
                                      reference["oracle/segment"])
        assert (st.dedup_seen == 0).all(), "ledger must drain"
        assert (st.dedup_epoch[:, 1] == 1).all()
        assert (st.credits == 0).all()
        assert not (st.error & 4).any()
        seen_retry |= bool((st.retransmits > 0).any())
    assert seen_retry, "no seed exercised a retransmit at 1% drop"


@pytest.mark.parametrize("source", SOURCES)
def test_contract_corruption_detected_and_recovered(reference, source):
    from repro_torch.core.state import ERR_CRC, CrcError, raise_on_error

    _, st = _port_put(PUTS["corrupt"], source)
    np.testing.assert_array_equal(st.segment.numpy(),
                                  reference["oracle/segment"])
    assert (st.dedup_seen == 0).all()
    assert (st.error & ERR_CRC).any(), "this seed corrupts a packet"
    with pytest.raises(CrcError, match="ERR_CRC"):
        raise_on_error(st, where="fault contracts")
    raise_on_error(st, where="fault contracts", ignore=ERR_CRC)


@pytest.mark.parametrize("source", SOURCES)
def test_contract_duplicates_are_idempotent(reference, source):
    _, st = _port_put(PUTS["dup-heavy"], source)
    np.testing.assert_array_equal(st.segment.numpy(),
                                  reference["oracle/segment"])
    assert (st.dedup_seen == 0).all()
    assert (st.error == 0).all()


@pytest.mark.parametrize("source", SOURCES)
def test_contract_dedup_off_double_applies(source):
    _, on = _port_put(PUTS["dedup-on-add"], source)
    _, off = _port_put(PUTS["dedup-off-add"], source)
    assert (on.segment[:, 10:10 + PAY] == 1.0).all()
    assert (off.segment[:, 10:10 + PAY] > 1.0).any(), \
        "without dedup a duplicated segment must double-apply H_ADD"


@pytest.mark.parametrize("source", SOURCES)
def test_contract_exhaustion_latches(source):
    """100 % drop: every sender latches ERR_RETRY_EXHAUSTED, no word
    lands, no credit appears, and a timeout wait latches no underflow
    (the elastic quorum mask of the reference's check is not ported)."""
    from repro_torch.core.state import (ERR_RETRY_EXHAUSTED,
                                        ERR_WAIT_UNDERFLOW,
                                        RetryExhaustedError, raise_on_error)

    _, st = _port_put(PUTS["exhausted"], source)
    assert (st.error & ERR_RETRY_EXHAUSTED).all()
    assert not (st.error & ERR_WAIT_UNDERFLOW).any()
    assert (st.segment[:, 10:10 + PAY] == 0).all()
    assert (st.credits == 0).all()
    with pytest.raises(RetryExhaustedError):
        raise_on_error(st, where="fault contracts")


@pytest.mark.parametrize("source", SOURCES)
def test_contract_async_is_fire_and_forget(reference, source):
    from repro_torch.core.state import ERR_RETRY_EXHAUSTED

    ctx, st = _port_put(PUTS["async"], source)
    seg = st.segment[:, 10:10 + PAY].numpy()
    assert (seg != reference["oracle/segment"][:, 10:10 + PAY]).any(), \
        "30% drop must lose something (no retransmit on async)"
    assert (st.retransmits == 0).all()
    assert not (st.error & ERR_RETRY_EXHAUSTED).any()
    assert ctx.exchanges == 1


@pytest.mark.parametrize("source", SOURCES)
def test_contract_determinism(source):
    case = dataclasses.replace(PUTS["corrupt"], drop=0.05, dup=0.05,
                               corrupt=0.05, seed=13)
    runs = [_port_put(case, source)[1] for _ in range(2)]
    for f in ("segment", "retransmits", "error", "tx_words"):
        assert torch.equal(getattr(runs[0], f), getattr(runs[1], f)), f
    other = _port_put(case, source, seed=14)[1]
    assert not all(torch.equal(getattr(other, f), getattr(runs[0], f))
                   for f in ("tx_words", "error", "retransmits"))


def test_unprotected_ops_and_lanes_refuse_lossy():
    """Every op but put_long refuses a lossy transport; put_long refuses
    the ack lanes, sub-32-bit payloads and more than 31 segments
    there."""
    from repro_torch import runtime
    from repro_torch.core import ops
    from repro_torch.core.faults import FaultModel
    from repro_torch.core.state import ShoalContext, replace

    t = runtime.LossyTransport(faults=FaultModel(drop=0.01, seed=1),
                               max_packet_bytes=MTU)
    ctx = ShoalContext(N, t, SEG, device="cpu")
    st, pay = ctx.make_state(), torch.ones(N, 4)
    for call in (
            lambda: ops.put_short(ctx, st, RING),
            lambda: ops.get_long(ctx, st, RING, 0, 4, 8, token=2),
            lambda: ops.put_long_vectored(ctx, st, [pay], RING, [0]),
            lambda: ops.put_long(ctx, st, pay, RING, 0, defer_ack=True),
            lambda: ops.put_long(ctx, st, pay, RING, 0, piggyback_token=2),
            lambda: ops.put_long(ctx, st, pay, RING, 0,
                                 reply_via=ctx.reply_mailbox()),
            lambda: ops.put_long(ctx, replace(
                st, segment=st.segment.bfloat16()), pay, RING, 0),
            lambda: ops.put_long(ctx, st, torch.ones(N, 4 * 32), RING, 0)):
        with pytest.raises(NotImplementedError):
            call()
    assert ctx.exchanges == 0


# -- deliver and the CRC, in process ------------------------------------------

@pytest.mark.parametrize("probs", [(0.3, 0.3, 0.3), (1.0, 0.0, 0.0),
                                   (0.0, 1.0, 1.0), (0.0, 0.0, 0.0)])
@pytest.mark.parametrize("nseg,width", [(1, 16), (4, 20), (9, 2266)])
def test_deliver_matches_reference_given_its_draws(probs, nseg, width):
    import jax.numpy as jnp

    from repro.core import faults as jflt
    from repro_torch.core import faults as flt

    rng = np.random.default_rng(nseg * 31 + width)
    rows = rng.integers(-2 ** 31, 2 ** 31, (nseg, width),
                        dtype=np.int64).astype(np.int32)
    rows[:, 0] = 3
    rows[::3, 0] = 0                              # NOP rows
    args = (5, 1, 2, 0, jflt.DIR_DATA)
    key = jflt.fault_key(jflt.FaultModel(seed=11), *args)
    want = np.asarray(jflt.deliver(jnp.asarray(rows), key, *map(
        jnp.float32, probs)))
    draws = _jax_draws(11)(torch.tensor([5]), 1, 2, 0, jflt.DIR_DATA, nseg,
                           width)
    got = flt.deliver(torch.from_numpy(rows)[None], draws,
                      *(torch.tensor([p], dtype=torch.float32)
                        for p in probs))[0]
    np.testing.assert_array_equal(got.numpy(), want)
    # a scalar probability and a (nseg, W) stack give the same rows
    got1 = flt.deliver(torch.from_numpy(rows),
                       flt.Draws(*(d[0] for d in draws)), *probs)
    np.testing.assert_array_equal(got1.numpy(), want)


@pytest.mark.parametrize("nseg", [1, 3])
def test_crc_catches_every_single_bit_flip(nseg):
    from repro_torch.core import am

    rng = np.random.default_rng(nseg)
    pkt = rng.integers(-2 ** 31, 2 ** 31, (nseg, am.HDR_WORDS + 4),
                       dtype=np.int64).astype(np.int32)
    pkt[:, 0] = am.LONG
    sealed = am.seal_packet(torch.from_numpy(pkt))
    assert am.packet_crc_ok(sealed).all()
    width = sealed.shape[-1]
    bit = torch.arange(width * 32)
    flip = torch.zeros(width * 32, width, dtype=torch.int64)
    flip[bit, bit // 32] = 1 << (bit % 32)
    flip = torch.where(flip >= 1 << 31, flip - (1 << 32), flip).to(
        torch.int32)
    for row in range(nseg):
        corr = sealed[None].repeat(width * 32, 1, 1)
        corr[:, row] ^= flip
        ok = am.packet_crc_ok(corr)
        assert not ok[:, row].any(), row
        assert ok.sum() == (nseg - 1) * width * 32


def test_hash_draws_are_pure_and_decorrelated():
    """The default draws are a pure function of their salts (two calls
    agree; a receiver's draws do not depend on its neighbours), lie in
    range, and any changed salt changes them."""
    from repro_torch.core.faults import hash_draws

    r = torch.arange(8, dtype=torch.int32)
    base = hash_draws(7, r, r * 0 + 1, r * 0 + 2, 3, 0, 6, 20)
    again = hash_draws(7, r, r * 0 + 1, r * 0 + 2, 3, 0, 6, 20)
    alone = hash_draws(7, r[5:6], r[5:6] * 0 + 1, r[5:6] * 0 + 2, 3, 0, 6,
                       20)
    for a, b, c in zip(base, again, alone):
        assert torch.equal(a, b) and torch.equal(a[5:6], c)
    for u in base[:3]:
        assert u.dtype == torch.float32 and (u >= 0).all() and (u < 1).all()
    assert (base.bit >= 0).all() and (base.bit < 20 * 32).all()
    salts = [(8, r, r * 0 + 1, r * 0 + 2, 3, 0), (7, r, r * 0 + 2,
                                                  r * 0 + 2, 3, 0),
             (7, r, r * 0 + 1, r * 0 + 3, 3, 0), (7, r, r * 0 + 1,
                                                  r * 0 + 2, 4, 0),
             (7, r, r * 0 + 1, r * 0 + 2, 3, 1)]
    for s in salts:
        other = hash_draws(*s, 6, 20)
        assert not torch.equal(other.drop, base.drop), s
    # the rows of one stack are decorrelated too
    assert len(set(base.drop[0].tolist())) == 6
    big = hash_draws(0, torch.arange(4096, dtype=torch.int32),
                     torch.zeros(4096, dtype=torch.int32),
                     torch.ones(4096, dtype=torch.int32), 0, 0, 4, 16)
    assert abs(float(big.drop.mean()) - 0.5) < 0.01


def test_fault_model_and_transport_validation():
    from repro_torch.core.faults import FaultModel
    from repro_torch.runtime import (LinkClass, LossyTransport,
                                     default_link_of)

    for bad in ({"drop": -0.1}, {"dup": 1.5}, {"corrupt": 2.0}):
        with pytest.raises(ValueError):
            FaultModel(**bad)
    assert FaultModel().lossless and not FaultModel(dup=0.1).lossless
    with pytest.raises(ValueError, match="FaultModel"):
        LossyTransport()
    with pytest.raises(ValueError, match="max_retries"):
        LossyTransport(faults=FaultModel(), max_retries=-1)
    t = LossyTransport(faults=FaultModel(drop=0.1, dup=0.2, corrupt=0.3))
    assert default_link_of(2, 2) == LinkClass.LOCAL
    assert default_link_of(2, 3) == LinkClass.DCN
    assert t.probs_for(0, 0) == (0.0, 0.0, 0.0)
    assert t.probs_for(0, 1) == (0.1, 0.2, 0.3)
    assert t.max_retries == 4 and t.lossy_links == (LinkClass.DCN,)
    pods = LossyTransport(faults=t.faults, link_of=lambda s, d: (
        LinkClass.ICI if s // 4 == d // 4 else LinkClass.DCN))
    assert not pods.link_is_lossy(0, 3) and pods.link_is_lossy(0, 4)


def test_topology_and_router_match_reference():
    from repro.runtime import router as jrouter, topology as jtopo
    from repro_torch.runtime import router, topology

    for shape, names, kernel_axes, pod_axis in (
            ((2, 4), ("pod", "chip"), None, "pod"),
            ((2, 2, 3), ("pod", "data", "model"), ("pod", "model"), "pod"),
            ((8,), ("kernel",), None, None)):
        spec = topology.ClusterSpec(shape, names, kernel_axes, pod_axis)
        jspec = jtopo.ClusterSpec(shape, names, kernel_axes, pod_axis)
        assert spec.num_kernels == jspec.num_kernels
        assert spec.num_devices == jspec.num_devices
        rt, jrt = router.Router(spec), jrouter.Router(jspec)
        n = spec.num_kernels
        for k in range(n):
            assert topology.kernel_coords(spec, k) == \
                jtopo.kernel_coords(jspec, k)
            assert topology.pod_of(spec, k) == jtopo.pod_of(jspec, k)
            assert rt.coords(k) == jrt.coords(k)
            for j in range(n):
                assert rt.classify(k, j).value == jrt.classify(k, j).value
        for shift in (1, 3):
            ring = topology.neighbors_ring(n, shift)
            assert ring == jtopo.neighbors_ring(n, shift)
            assert rt.classify_pattern(ring).value == \
                jrt.classify_pattern(ring).value
            assert rt.is_pure_local(ring) == jrt.is_pure_local(ring)
        with pytest.raises(ValueError):
            topology.kernel_coords(spec, n)
    assert router.Router(spec).is_pure_local([(0, 0), (3, 3)])
    with pytest.raises(ValueError):
        topology.pairwise([(0, 1), (2, 1)])
    assert topology.pairwise([(0, 1), (1, 0)]) == [(0, 1), (1, 0)]
    for bad in (((2,), ("a", "b")), ((2,), ("a",), ("b",)),
                ((2,), ("a",), None, "p")):
        with pytest.raises(ValueError):
            topology.ClusterSpec(*bad)


# -- the dedup-gated ingress on hand-built stacks ----------------------------

W4 = 4


def _row(*, seg, epoch, final, token=1, handler=1, addr=10, src=0, dst=1,
         live=True):
    from repro_torch.core import am

    if not live:
        return np.zeros(am.HDR_WORDS, np.int32)
    t = am.make_type(am.LONG, asynchronous=not final, fifo=True)
    return am.encode(type=t, src=src, dst=dst, nwords=W4,
                     dst_addr=addr + W4 * seg, handler=handler, token=token,
                     seq=W4 * seg, epoch=epoch).numpy()


def _msg(nseg, epoch, **kw):
    return [_row(seg=s, epoch=epoch, final=s == nseg - 1, **kw)
            for s in range(nseg)]


def _ledger(done=0, infl=0, seen=0, token=1):
    z = np.zeros((3, 16), np.int32)
    z[0, token], z[1, token], z[2, token] = done, infl, seen
    return z


# name -> per kernel (rows, ledger (3, 16): epoch / inflight / seen), dedup,
# segment words
STACKS = {
    "duplicates": ([
        (_msg(4, 1) + [_msg(4, 1)[1], _msg(4, 1)[3]], _ledger()),
        (_msg(4, 1)[::-1] + _msg(4, 1), _ledger()),
        (_msg(4, 2)[:3] + _msg(4, 2)[:3], _ledger(done=1)),
    ], True, 64),
    "stale-epochs": ([
        (_msg(4, 2), _ledger(done=2)),
        (_msg(4, 1) + _msg(4, 3), _ledger(done=2)),
        (_msg(4, 3), _ledger(done=2, infl=3, seen=0b0101)),
    ], True, 64),
    "stale-final-only": ([
        ([_msg(4, 5)[3]], _ledger(done=5)),
        ([_msg(4, 5)[3], _row(seg=0, epoch=0, final=False, live=False)],
         _ledger(done=6)),
        ([_msg(2, 1)[1]], _ledger()),
    ], True, 64),
    "segment-30": ([
        (_msg(31, 1, addr=0), _ledger()),
        (_msg(31, 1, addr=0)[1:] + [_msg(31, 1, addr=0)[0]], _ledger()),
        (_msg(31, 1, addr=0)[:30], _ledger()),
    ], True, 130),
    "tokens-and-nops": ([
        (_msg(2, 1, token=3) + [_row(seg=0, epoch=0, final=False,
                                     live=False)] + _msg(2, 4, token=1),
         _ledger(done=3)),
        (_msg(3, 2, token=15, handler=2) + _msg(3, 2, token=15, handler=2),
         _ledger(token=15, infl=2, seen=0b1)),
        ([_row(seg=0, epoch=0, final=False, live=False)] * 2, _ledger()),
    ], True, 64),
    "dedup-off-add": ([
        (_msg(4, 1, handler=2) + [_msg(4, 1, handler=2)[2]], _ledger()),
        (_msg(4, 2, handler=2) * 2, _ledger(done=2)),
        (_msg(2, 1, handler=2), _ledger()),
    ], False, 64),
}


def _stack_inputs(name):
    kernels, dedup, S = STACKS[name]
    R = max(len(rows) for rows, _ in kernels)
    K = len(kernels)
    hdr = np.zeros((K, R, 16), np.int32)
    for k, (rows, _) in enumerate(kernels):
        hdr[k, :len(rows)] = np.stack(rows)
    rng = np.random.default_rng(len(name))
    pay = rng.standard_normal((K, R, W4)).astype(np.float32)
    seg = rng.standard_normal((K, S)).astype(np.float32)
    ledger = np.stack([lg for _, lg in kernels])       # (K, 3, 16)
    return hdr, pay, seg, ledger, dedup, S


@pytest.mark.parametrize("name", list(STACKS))
def test_ingress_reliable_stack_matches_reference(name):
    """Per kernel, the JAX package's ``ingress_reliable_stack`` (which
    runs on one device) against the port's over the kernel axis."""
    import jax
    import jax.numpy as jnp

    from repro.core import gascore as jgc
    from repro.core.state import PgasState as JState, ShoalContext as JCtx
    from repro.runtime.topology import make_cpu_mesh
    from repro_torch.core import gascore as gc
    from repro_torch.core.state import ShoalContext, replace

    hdr, pay, seg, ledger, dedup, S = _stack_inputs(name)
    K = hdr.shape[0]
    ctx = ShoalContext(K, segment_words=S, device="cpu")
    st = replace(ctx.make_state(), segment=torch.from_numpy(seg),
                 dedup_epoch=torch.from_numpy(ledger[:, 0].copy()),
                 dedup_inflight=torch.from_numpy(ledger[:, 1].copy()),
                 dedup_seen=torch.from_numpy(ledger[:, 2].copy()))
    got, ack = gc.ingress_reliable_stack(ctx, st, torch.from_numpy(hdr),
                                         torch.from_numpy(pay), W4,
                                         dedup=dedup)
    jctx = JCtx(mesh=make_cpu_mesh(1, ("kernel",)), axes=("kernel",),
                segment_words=S)
    fn = jax.jit(lambda s, h, p: jgc.ingress_reliable_stack(
        jctx, s, h, p, W4, dedup=dedup))
    for k in range(K):
        js = dataclasses.replace(
            JState.make(S), segment=jnp.asarray(seg[k]),
            dedup_epoch=jnp.asarray(ledger[k, 0]),
            dedup_inflight=jnp.asarray(ledger[k, 1]),
            dedup_seen=jnp.asarray(ledger[k, 2]))
        want, want_ack = fn(js, jnp.asarray(hdr[k]), jnp.asarray(pay[k]))
        for f in ("segment", "dedup_epoch", "dedup_inflight", "dedup_seen",
                  "rx_words"):
            np.testing.assert_array_equal(
                getattr(got, f)[k].numpy(), np.asarray(getattr(want, f)),
                err_msg=f"{name} kernel {k}: {f}")
        np.testing.assert_array_equal(ack[k].numpy(), np.asarray(want_ack),
                                      err_msg=f"{name} kernel {k}: ack")


def _numpy_replay(hdr, pay, seg, ledger, W, dedup):
    """``src/repro/core/gascore.py:477-515`` row by row in numpy, for
    H_WRITE / H_ADD rows: returns segment, ledger, rx_words, ack."""
    from repro_torch.core import am

    seg, ledger = seg.copy(), ledger.copy()
    K, R, _ = hdr.shape
    S = seg.shape[1]
    rx = np.zeros(K, np.int64)
    ack = np.zeros((K, am.HDR_WORDS), np.int32)
    for k in range(K):
        for r in range(R):
            h = {f: int(hdr[k, r, i]) for i, f in enumerate(am.FIELDS)}
            active = (h["type"] & 7) == am.LONG
            tok = min(max(h["token"], 0), 15)
            seg_i = min(max(h["seq"] // W, 0), 30)
            bit = 1 << seg_i
            final = active and not h["type"] & am.FLAG_ASYNC \
                and not h["type"] & am.FLAG_REPLY
            if dedup:
                done = ledger[k, 0, tok]
                stale = active and h["epoch"] <= done
                seen = ledger[k, 2, tok] if ledger[k, 1, tok] == h["epoch"] \
                    else 0
                fresh = active and not stale and not seen & bit
                seen2 = seen | bit if active and not stale else seen
                complete = final and not stale and seen2 == (bit << 1) - 1
                if complete:
                    ledger[k, 0, tok] = h["epoch"]
                if active and not stale:
                    ledger[k, 1, tok] = h["epoch"]
                    ledger[k, 2, tok] = 0 if complete else seen2
                ack_now = complete or (stale and final)
            else:
                fresh, ack_now = active, final
            if fresh:
                a = min(max(h["dst_addr"], 0), S)
                n = min(h["nwords"], W, S - a)
                if h["handler"] == 2:
                    seg[k, a:a + n] += pay[k, r, :n]
                else:
                    seg[k, a:a + n] = pay[k, r, :n]
                rx[k] += h["nwords"]
            if ack_now:
                ack[k] = am.encode(
                    type=am.make_type(am.SHORT, asynchronous=True,
                                      reply=True),
                    src=h["dst"], dst=h["src"], token=h["token"]).numpy()
    return seg, ledger, rx, ack


@settings(max_examples=6, deadline=None)
@given(st.integers(1, 6), st.integers(0, 2 ** 16), st.booleans())
def test_ingress_reliable_stack_matches_numpy_replay(nseg, seed, dedup):
    """Property: random redelivery stacks (segments of two messages on
    two tokens, shuffled, duplicated, dropped, stale epochs) through the
    port equal the numpy replay of the reference's scan body."""
    from repro_torch.core import gascore as gc
    from repro_torch.core.state import ShoalContext, replace

    rng = np.random.default_rng(seed)
    K, S = 4, 64
    stacks = []
    for k in range(K):
        rows = []
        for token in (1, 2):
            ep = int(rng.integers(1, 4))
            rows += _msg(nseg, ep, token=token,
                         handler=int(rng.choice([1, 2])),
                         addr=int(rng.integers(0, 40)))
        rows = [rows[i] for i in rng.permutation(len(rows))
                if rng.random() > 0.2]
        rows += [rows[i] for i in range(len(rows)) if rng.random() < 0.3]
        stacks.append(rows or [np.zeros(16, np.int32)])
    R = max(len(r) for r in stacks)
    hdr = np.zeros((K, R, 16), np.int32)
    for k, rows in enumerate(stacks):
        hdr[k, :len(rows)] = np.stack(rows)
    pay = rng.standard_normal((K, R, W4)).astype(np.float32)
    seg = rng.standard_normal((K, S)).astype(np.float32)
    ledger = rng.integers(0, 3, (K, 3, 16)).astype(np.int32)
    ledger[:, 2] = rng.integers(0, 1 << nseg, (K, 16))
    ctx = ShoalContext(K, segment_words=S, device="cpu")
    st0 = replace(ctx.make_state(), segment=torch.from_numpy(seg),
                  dedup_epoch=torch.from_numpy(ledger[:, 0].copy()),
                  dedup_inflight=torch.from_numpy(ledger[:, 1].copy()),
                  dedup_seen=torch.from_numpy(ledger[:, 2].copy()))
    got, ack = gc.ingress_reliable_stack(ctx, st0, torch.from_numpy(hdr),
                                         torch.from_numpy(pay), W4,
                                         dedup=dedup)
    w_seg, w_ledger, w_rx, w_ack = _numpy_replay(hdr, pay, seg, ledger, W4,
                                                 dedup)
    np.testing.assert_array_equal(got.segment.numpy(), w_seg)
    for i, f in enumerate(("dedup_epoch", "dedup_inflight", "dedup_seen")):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      w_ledger[:, i], err_msg=f)
    np.testing.assert_array_equal(got.rx_words.numpy(), w_rx)
    np.testing.assert_array_equal(ack.numpy(), w_ack)


if __name__ == "__main__":
    _run_reference(sys.argv[1])
