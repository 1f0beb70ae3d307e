"""The port's actor layer (mailboxes, ``reply_via=``, metadata lanes) on
8 kernels against the JAX package's.

The JAX reference runs every case once, in one subprocess with 8
emulated CPU devices (``python tests/test_torch_actors.py OUT.npz``
writes its states and collective-permute counts): the mailbox programs
of ``tests/actor_checks.py`` that run there (the mixed-class stack, 1024
sends in one flush, the grouped ``MultiMailbox`` flush, watermark
autoflush, reply coalescing, an async put with no reply exchange) and
``reply_via=`` on each of the six puts through a ``ReplyMailbox``.  The
port runs the same program source on the CPU along its kernel axis;
every PgasState field must be equal (tolerance: none) and the port's
exchange count must equal the reference's collective-permute count
(1024 sends: 2 acked, 1 on UDP).  The mailbox flush on a pure-local
pattern does not run in the JAX package (its handler switch refuses the
branch types there), so the port's is held to
``actor_checks.sequential_schedule_oracle`` and the reference test's
own asserted values.  ``pack_meta_lane`` / ``unpack_meta_lane`` run
against the reference in process, bit for bit.
"""

import dataclasses
import os
import sys
import types

import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, strategies as st

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_reference import N, run_reference, spmd_run  # noqa: E402

RING = [(i, (i + 1) % N) for i in range(N)]
EVEN = [(i, i + 1) for i in range(0, N, 2)]
ODD = [(i, (i + 1) % N) for i in range(1, N, 2)]


# -- programs, one source for both packages ---------------------------------

def _mixed_stack(lib, ctx, st, p):
    mb = ctx.mailbox(RING, msg_words=4, watermark=1024, token=5)
    for i in range(6):
        st = mb.send(st, p[..., 4 * i:4 * i + 4] + 100 * i, dst_addr=8 * i)
    st = mb.send(st, np.full((4,), 0.5, np.float32), dst_addr=0,
                 handler=lib.hd.H_ADD)
    st = mb.send_signal(st, handler=lib.hd.H_ADD, arg=3, token=7)
    st = mb.flush(st)
    assert mb.flushes == 1 and mb.msgs_sent == 8 and mb.pending == 0
    return lib.ops.wait_replies(ctx, st, 5, 1)


def _sends_1024(lib, ctx, st, p):
    mb = ctx.mailbox(RING, msg_words=4, watermark=1 << 20, token=1)
    base = np.arange(4, dtype=np.float32)
    for i in range(1024):
        st = mb.send(st, base + i, dst_addr=4 * i)
    st = mb.flush(st)
    if ctx.transport.acked:
        st = lib.ops.wait_replies(ctx, st, 1, 1)
    return st


def _multi(lib, ctx, st, p):
    mmb = lib.actors.MultiMailbox(ctx, [EVEN, ODD], msg_words=4,
                                  watermark=1 << 20, token=6)
    for i in range(3):
        st = mmb.send(st, 0, p[..., 4 * i:4 * i + 4], dst_addr=4 * i)
        st = mmb.send(st, 1, -p[..., 12 + 4 * i:16 + 4 * i],
                      dst_addr=16 + 4 * i)
    st = mmb.flush(st)
    assert mmb.flushes == 1 and mmb.pending == 0 and mmb.msgs_sent == 6
    assert mmb.groups == [[0, 1]]
    return lib.ops.wait_replies(ctx, st, 6, 1)


def _watermark(lib, ctx, st, p):
    mb = ctx.mailbox(RING, msg_words=2, watermark=4, token=3)
    for i in range(10):
        st = mb.send(st, np.asarray([float(i), 0.0]), dst_addr=2 * i)
    assert mb.flushes == 2 and mb.pending == 2
    st = mb.flush(st)
    assert mb.flushes == 3
    return lib.ops.wait_replies(ctx, st, 3, 3)


def _reply_coalesce(lib, ctx, st, p):
    rmb = ctx.reply_mailbox()
    for a in (0, 8, 16):
        st = lib.ops.put_long(ctx, st, p[..., :4], RING, dst_addr=a,
                              token=2, reply_via=rmb)
    assert rmb.pending == 3
    st = rmb.flush(st)
    return lib.ops.wait_replies(ctx, st, 2, 3)


def _async_put(lib, ctx, st, p):
    return lib.ops.put_long(ctx, st, p[..., :4], RING, dst_addr=0,
                            asynchronous=True)


def _mixed_flags_ring(lib, ctx, st, p):
    """The mixed-flag flush (one credit per flush on the mailbox token,
    per-message tokens untouched) on a ring."""
    mb = ctx.mailbox(RING, msg_words=2, watermark=100, token=6)
    st = mb.send(st, np.asarray([1.0, 2.0]), dst_addr=0, token=1)
    st = mb.send(st, np.asarray([3.0]), dst_addr=4, handler=lib.hd.H_ADD,
                 token=2)
    st = mb.send_signal(st, arg=5, token=9)
    st = mb.flush(st)
    st = mb.send(st, p[..., :1], dst_addr=8, token=3)
    st = mb.flush(st)
    assert mb.flushes == 2
    return st


def _mailbox_reply_via(lib, ctx, st, p):
    rmb = ctx.reply_mailbox()
    mb = ctx.mailbox(RING, msg_words=4, token=4, reply_via=rmb)
    for i in range(3):
        st = mb.send(st, p[..., 4 * i:4 * i + 4], dst_addr=4 * i)
        st = mb.flush(st)
    assert rmb.pending == 3
    st = rmb.flush(st)
    return lib.ops.wait_replies(ctx, st, 4, 3)


def _short_signals(lib, ctx, st, p):
    """Short rows with every built-in handler in one flush: the credit
    file sees them in row order."""
    mb = ctx.mailbox(RING, msg_words=2, watermark=100, token=1)
    hd = lib.hd
    for h, a in ((hd.H_ADD, 4), (hd.H_MAX, 9), (hd.H_ADD, -2),
                 (hd.H_WRITE, 5), (hd.H_MIN, 3), (hd.H_ADD, 1)):
        st = mb.send_signal(st, handler=h, arg=a, token=8)
    st = mb.send(st, p[..., :2], dst_addr=3)
    return mb.flush(st)


def _via(op):
    """``op`` twice with ``reply_via`` (two owed credits on one key),
    one coalesced reply at the flush, then the wait.  The two calls
    differ, so the compiled reference cannot merge their exchanges."""
    def prog(lib, ctx, st, p):
        ops, hd = lib.ops, lib.hd
        rmb = ctx.reply_mailbox()
        for rep in range(2):
            if op == "put_short":
                st = ops.put_short(ctx, st, RING, arg=2 + rep, token=3,
                                   reply_via=rmb)
            elif op == "put_medium":
                st, _ = ops.put_medium(ctx, st, p[..., 6 * rep:6 * rep + 6],
                                       RING, token=3, reply_via=rmb)
            elif op == "put_long":
                st = ops.put_long(ctx, st, p, RING, dst_addr=4 + 20 * rep,
                                  token=3, reply_via=rmb)
            elif op == "put_long_multi":
                st = ops.put_long_multi(
                    ctx, st, [(p[..., :4], EVEN, 40 * rep),
                              (p[..., 4:8], ODD, 40 * rep + 8)],
                    token=3, reply_via=rmb)
            elif op == "put_long_strided":
                st = ops.put_long_strided(ctx, st, p[..., :12], RING,
                                          50 * rep, 5, blk_words=3,
                                          nblocks=4, token=3,
                                          handler=hd.H_ADD, reply_via=rmb)
            else:
                st = ops.put_long_vectored(
                    ctx, st, [p[..., :3], p[..., 3:8]], RING,
                    [40 * rep, 40 * rep + 10], token=3, reply_via=rmb)
        owed = 4 if op == "put_long_multi" else 2
        assert rmb.pending == owed, (op, rmb.pending)
        st = rmb.flush(st)
        assert rmb.pending == 0
        return ops.wait_replies(ctx, st, 3, 2)
    return prog


@dataclasses.dataclass(frozen=True)
class Case:
    prog: object
    acked: bool = True
    segment_words: int = 96
    payload_words: int = 24
    exchanges: int | None = None     # the target stated for the case


SIX_PUTS = ("put_short", "put_medium", "put_long", "put_long_multi",
            "put_long_strided", "put_long_vectored")

CASES = {
    "mixed-stack": Case(_mixed_stack, exchanges=2),
    "1024-sends": Case(_sends_1024, segment_words=4160, exchanges=2),
    "1024-sends-udp": Case(_sends_1024, acked=False, segment_words=4160,
                           exchanges=1),
    "multi-mailbox": Case(_multi, exchanges=2),
    "watermark": Case(_watermark, exchanges=6),
    "reply-coalesce": Case(_reply_coalesce, exchanges=4),
    "async-put": Case(_async_put, exchanges=1),
    "mixed-flags-ring": Case(_mixed_flags_ring, exchanges=4),
    "mailbox-reply_via": Case(_mailbox_reply_via, exchanges=4),
    "short-signals": Case(_short_signals, exchanges=2),
    **{f"reply_via-{op}": Case(_via(op)) for op in SIX_PUTS},
}


def _inputs(name):
    case = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name) + 500)
    seg0 = rng.standard_normal((N, case.segment_words)).astype(np.float32)
    pay = rng.standard_normal((N, case.payload_words)).astype(np.float32)
    return seg0, pay


def _run_reference(out_path):
    import jax.numpy as jnp

    from repro import actors, runtime
    from repro.core import handlers as hd, ops
    from repro.core.address_space import GlobalAddressSpace
    from repro.core.state import ShoalContext

    lib = types.SimpleNamespace(ops=ops, hd=hd, actors=actors)
    mesh = runtime.make_cpu_mesh(N, ("kernel",))
    out = {}
    for name, case in CASES.items():
        ctx = ShoalContext(mesh=mesh, axes=("kernel",),
                           transport=runtime.TCP if case.acked
                           else runtime.UDP,
                           segment_words=case.segment_words)
        seg0, pay = _inputs(name)
        st0 = GlobalAddressSpace(ctx).make_global_state(seg0.reshape(-1))
        st, _, cps, _ = spmd_run(
            mesh, lambda s, p, case=case, ctx=ctx: (
                case.prog(lib, ctx, s, p), ()), st0, jnp.asarray(pay))
        for f in dataclasses.fields(st):
            out[f"{name}/{f.name}"] = np.asarray(getattr(st, f.name))
        out[f"{name}/cps"] = np.asarray(cps)
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(__file__,
                         tmp_path_factory.mktemp("actors") / "ref.npz")


def _port_lib():
    from repro_torch import actors
    from repro_torch.core import handlers as hd, ops

    return types.SimpleNamespace(ops=ops, hd=hd, actors=actors)


@pytest.mark.parametrize("name", list(CASES))
def test_actor_programs_match_reference(reference, name):
    from repro_torch import runtime
    from repro_torch.core.address_space import GlobalAddressSpace
    from repro_torch.core.state import ShoalContext, state_to_numpy

    case = CASES[name]
    ctx = ShoalContext(N, runtime.TCP if case.acked else runtime.UDP,
                       case.segment_words, device="cpu")
    seg0, pay = _inputs(name)
    st = GlobalAddressSpace(ctx).make_global_state(seg0.reshape(-1))
    st = case.prog(_port_lib(), ctx, st, torch.from_numpy(pay))
    got = state_to_numpy(st)
    for f, arr in got.items():
        np.testing.assert_array_equal(arr, reference[f"{name}/{f}"],
                                      err_msg=f"{name}: {f}")
    assert ctx.exchanges == int(reference[f"{name}/cps"]), \
        (name, ctx.exchanges, int(reference[f"{name}/cps"]))
    if case.exchanges is not None:
        assert ctx.exchanges == case.exchanges
    assert not got["error"].any()


# -- the pure-local flush, held to the schedule oracle ----------------------

def _local(segment_words=64):
    from repro_torch.core.state import ShoalContext

    ctx = ShoalContext(1, segment_words=segment_words, device="cpu")
    return ctx, ctx.make_state()


def test_local_mixed_flag_flush_matches_oracle():
    """``test_handlers_gascore``'s mixed-flag flush on one kernel: one
    ack credit per flush on the mailbox token, the user Short's handler
    on its own token, per-message tokens untouched, and the segment of
    the puts in program order (the oracle's)."""
    from actor_checks import sequential_schedule_oracle

    from repro_torch.core import handlers as hd

    ctx, st = _local()
    mb = ctx.mailbox([(0, 0)], msg_words=2, watermark=100, token=6)
    st = mb.send(st, np.asarray([1.0, 2.0]), dst_addr=0, token=1)
    st = mb.send(st, np.asarray([3.0]), dst_addr=4, handler=hd.H_ADD,
                 token=2)
    st = mb.send_signal(st, arg=5, token=9)
    st = mb.flush(st)
    st = mb.send(st, np.asarray([7.0]), dst_addr=8, token=3)
    st = mb.flush(st)
    assert mb.flushes == 2 and ctx.exchanges == 0   # local: no exchange
    # each flush: its rows in one group, the final row acked on token 6
    oracle = sequential_schedule_oracle([
        ("put", 0, 1, 1.0, 6, False, 0), ("put", 1, 1, 2.0, 6, False, 0),
        ("put", 4, 1, 3.0, 6, True, 0),
        ("put", 8, 1, 7.0, 6, True, 1)], 64)
    np.testing.assert_array_equal(st.segment[0].numpy(), oracle["segment"])
    assert oracle["leaked_tokens"] == [6]       # two acks, never waited
    cred = st.credits[0].numpy()
    assert cred[6] == 2 and cred[9] == 5, cred
    assert cred[1] == 0 and cred[2] == 0 and cred[3] == 0, cred


def test_local_flush_semantics_match_oracle():
    """``test_actors``' local flush: a payload row, an H_ADD row on the
    same words and a Short signal, then the wait on the mailbox token."""
    from actor_checks import sequential_schedule_oracle

    from repro_torch.core import handlers as hd, ops

    ctx, st = _local()
    mb = ctx.mailbox([(0, 0)], msg_words=4, watermark=100, token=5)
    st = mb.send(st, np.arange(1.0, 5.0), dst_addr=8)
    st = mb.send(st, np.asarray([2.0]), dst_addr=8, handler=hd.H_ADD)
    st = mb.send_signal(st, arg=4, token=7)
    st = mb.flush(st)
    st = ops.wait_replies(ctx, st, 5, 1)
    oracle = sequential_schedule_oracle(
        [("put", 8, 1, 3.0, 5, False, 0), ("put", 9, 1, 2.0, 5, False, 0),
         ("put", 10, 1, 3.0, 5, False, 0), ("put", 11, 1, 4.0, 5, True, 0),
         ("wait", 5, 1)], 64)
    np.testing.assert_array_equal(st.segment[0].numpy(), oracle["segment"])
    assert oracle["leaked_tokens"] == [] and not oracle["underflow_events"]
    cred = st.credits[0].numpy()
    assert cred[5] == 0 and cred[7] == 4, cred
    assert int(st.error[0]) == 0


def test_mailbox_argument_checks():
    from repro_torch.actors import Mailbox, MultiMailbox
    from repro_torch.core import am

    ctx, st = _local()
    with pytest.raises(TypeError, match="32-bit"):
        Mailbox(ctx, [(0, 0)], msg_words=4, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="msg_words"):
        Mailbox(ctx, [(0, 0)], msg_words=0)
    with pytest.raises(ValueError, match="watermark"):
        Mailbox(ctx, [(0, 0)], msg_words=4, watermark=0)
    with pytest.raises(ValueError, match="at least one pattern"):
        MultiMailbox(ctx, [], msg_words=4)
    mb = Mailbox(ctx, [(0, 0)], msg_words=4)
    with pytest.raises(ValueError, match="exceeds msg_words"):
        mb.send(st, np.arange(5.0))
    with pytest.raises(ValueError, match="need a payload"):
        mb.send(st, None)
    with pytest.raises(ValueError, match="no payload"):
        mb.send(st, np.arange(2.0), msg_class=am.SHORT)
    with pytest.raises(ValueError, match="Medium"):
        mb.send(st, np.arange(2.0), msg_class=am.MEDIUM)
    assert mb.pending == 0
    assert mb.flush(st) is st and mb.flushes == 0


def test_reply_via_refusals():
    """``reply_via`` needs one int token, and does not combine with
    ``defer_ack`` (the reference's refusals)."""
    from repro_torch.core import ops
    from repro_torch.core.state import ShoalContext

    ctx = ShoalContext(N, segment_words=64, device="cpu")
    st, rmb = ctx.make_state(), ctx.reply_mailbox()
    with pytest.raises(ValueError, match="pick one"):
        ops.put_long(ctx, st, torch.ones(N, 4), RING, 0, defer_ack=True,
                     reply_via=rmb)
    with pytest.raises(ValueError, match="pick one"):
        ops.put_long_multi(ctx, st, [(torch.ones(N, 4), RING, 0)],
                           defer_ack=True, reply_via=rmb)
    with pytest.raises(ValueError, match="one int"):
        ops.put_long(ctx, st, torch.ones(N, 4), RING, 0,
                     token=ctx.my_id() % 2, reply_via=rmb)


@settings(max_examples=6, deadline=None)
@given(st.lists(st.sampled_from([0, 1, 2, 3, 4]), min_size=1, max_size=8),
       st.lists(st.integers(-50, 50), min_size=8, max_size=8))
def test_credit_rows_equal_the_row_walk(handlers, args):
    """Property: ``ingress_stack``'s credit updates (scatter-adds where
    every Short row adds, the row walk otherwise) equal walking the rows
    one by one, for stacks mixing Short rows of every handler, replies,
    deferred acks and piggybacked acks over a few tokens."""
    from repro_torch.core import am, gascore as gc
    from repro_torch.core.state import ShoalContext, replace

    ctx = ShoalContext(N, segment_words=32, device="cpu")
    g = torch.Generator().manual_seed(len(handlers) * 31 + args[0])
    R = len(handlers)
    rows = []
    for r, h in enumerate(handlers):
        kind = int(torch.randint(0, 4, (1,), generator=g))
        t = [am.make_type(am.SHORT, asynchronous=True),
             am.make_type(am.SHORT, asynchronous=True, reply=True),
             am.make_type(am.LONG, defer_ack=True),
             am.make_type(am.LONG, asynchronous=True) | am.FLAG_PIGGYBACK
             ][kind]
        rows.append(am.encode(
            type=torch.full((N,), t, dtype=torch.int32),
            token=torch.randint(0, 3, (N,), generator=g),
            handler=h, dst_addr=args[r % 8],
            pb_token=torch.randint(0, 3, (N,), generator=g),
            pb_count=args[(r + 3) % 8]))
    hdr_rows = torch.stack(rows, dim=1)
    st0 = ctx.make_state()
    st0 = replace(st0, credits=torch.randint(-9, 9, st0.credits.shape,
                                             generator=g, dtype=torch.int32))
    fast = gc._credit_rows(ctx, st0, hdr_rows)
    walk = gc._credit_walk(ctx, st0, hdr_rows)
    assert torch.equal(fast.credits, walk.credits), (handlers, R)
    assert torch.equal(fast.deferred_acks, walk.deferred_acks)
    # the caller's own verdict, where it knows its handlers, agrees
    told = gc._credit_rows(ctx, st0, hdr_rows, additive=gc.adds_only(
        ctx.handlers, handlers))
    assert torch.equal(told.credits, walk.credits)
    assert torch.equal(told.deferred_acks, walk.deferred_acks)


def test_adds_only_reads_handlers_as_clipped():
    from repro_torch.core import gascore as gc, handlers as hd

    table = hd.HandlerTable()
    assert gc.adds_only(table, []) is True
    assert gc.adds_only(table, [hd.H_ADD, hd.H_NOP, -3]) is True
    assert gc.adds_only(table, [hd.H_ADD, hd.H_MAX]) is False
    assert gc.adds_only(table, [9]) is False         # clips to H_MIN
    assert gc.adds_only(table, [hd.H_ADD, None]) is None


# -- metadata lanes, in process against the reference -----------------------

@pytest.mark.parametrize("dtype", ["float32", "int32", "bfloat16",
                                   "float16"])
def test_meta_lanes_match_reference_bitwise(dtype):
    import jax.numpy as jnp

    from repro.actors import pack_meta_lane as jpack, unpack_meta_lane as junp
    from repro_torch.actors import pack_meta_lane, unpack_meta_lane

    rng = np.random.default_rng(7)
    lo, hi = ((-2 ** 31, 2 ** 31 - 1) if dtype in ("float32", "int32")
              else (-2 ** 15, 2 ** 15 - 1))
    meta = np.concatenate([[lo, hi, 0, -1, 1],
                           rng.integers(lo, hi, 64)]).astype(np.int32)
    want = jpack(jnp.asarray(meta), getattr(jnp, dtype))
    got = pack_meta_lane(torch.from_numpy(meta), getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    bits = {4: (np.int32, torch.int32), 2: (np.int16, torch.int16)}[
        got.element_size()]
    np.testing.assert_array_equal(
        got.view(bits[1]).numpy(),
        np.asarray(want).view(bits[0]))
    back = unpack_meta_lane(got)
    np.testing.assert_array_equal(back.numpy(), np.asarray(junp(want)))
    np.testing.assert_array_equal(back.numpy(), meta)
    with pytest.raises(TypeError):
        pack_meta_lane(torch.from_numpy(meta), torch.float64)


if __name__ == "__main__":
    _run_reference(sys.argv[1])
