"""The port's GAScore stages against the JAX package's, on the CPU.

The port runs K kernels along its leading axis; the reference runs each
kernel's slice on one device (these stages never ask for the kernel id).
Every PgasState field and every returned buffer must match exactly: the
stages move words and apply one handler operation per word in the same
order on both sides (tolerance: none).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import am as jam, gascore as jgc, handlers as jhd
from repro.core.state import PgasState as JaxState, ShoalContext as JaxCtx
from repro.runtime.topology import make_cpu_mesh
from repro_torch.core import am as tam, gascore as tgc
from repro_torch.core.state import (FIELDS, ShoalContext, state_from_numpy,
                                    state_to_numpy)

K, S, W = 3, 64, 16


def _states(seed, dtype="float32"):
    rng = np.random.default_rng(seed)
    proto = JaxState.make(S, jnp.dtype(dtype))
    d = {f: np.stack([np.asarray(getattr(proto, f))] * K) for f in FIELDS}
    d["segment"] = (rng.standard_normal((K, S)) * 4).astype(dtype)
    d["credits"] = rng.integers(0, 4, (K, jhd.NUM_TOKENS)).astype(np.int32)
    d["deferred_acks"] = rng.integers(0, 3, (K, jhd.NUM_TOKENS)).astype(
        np.int32)
    d["rx_words"] = rng.integers(0, 100, K).astype(np.int32)
    d["tx_words"] = rng.integers(0, 100, K).astype(np.int32)
    jax_states = [JaxState(**{f: jnp.asarray(d[f][k]) for f in FIELDS})
                  for k in range(K)]
    return state_from_numpy(d, device="cpu"), jax_states, rng


def _ctxs():
    jctx = JaxCtx(mesh=make_cpu_mesh(1, ("kernel",)), axes=("kernel",),
                  segment_words=S)
    return ShoalContext(K, segment_words=S, device="cpu"), jctx


def _assert_states(port, jax_states):
    got = state_to_numpy(port)
    for f in FIELDS:
        want = np.stack([np.asarray(getattr(s, f)) for s in jax_states])
        np.testing.assert_array_equal(got[f], want, err_msg=f)


def _rows(per_kernel_fields):
    """(K, nseg, HDR) int32 rows from per-kernel lists of field dicts."""
    return np.stack([np.stack([np.asarray(jam.encode(**f)) for f in rows])
                     for rows in per_kernel_fields]).astype(np.int32)


LONG = jam.make_type(jam.LONG)


@pytest.mark.parametrize("fifo", [False, True])
def test_egress_batch(fifo):
    ctx, jctx = _ctxs()
    st, jst, rng = _states(1)
    rows = _rows([[dict(type=LONG, nwords=W, src_addr=0),
                   dict(type=LONG, nwords=5, src_addr=W)],
                  [dict(type=LONG, nwords=W, src_addr=S - 4),
                   dict(type=LONG, nwords=W, src_addr=-7)],
                  [dict(), dict()]])
    fifo_np = rng.standard_normal((K, 2 * W - 3)).astype(np.float32) \
        if fifo else None
    got = tgc.egress_batch(ctx, st, torch.from_numpy(rows),
                           None if fifo_np is None else
                           torch.from_numpy(fifo_np), W)
    for k in range(K):
        want = jgc.egress_batch(jctx, jst[k], jnp.asarray(rows[k]),
                                None if fifo_np is None else
                                jnp.asarray(fifo_np[k]), W)
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want))


def test_egress_single_packet():
    ctx, jctx = _ctxs()
    st, jst, _ = _states(2)
    rows = _rows([[dict(type=LONG, nwords=9, src_addr=S - 3)]] * K)
    got = tgc.egress(ctx, st, tam.decode(torch.from_numpy(rows[:, 0])),
                     None, W)
    for k in range(K):
        want = jgc.egress(jctx, jst[k], jam.decode(jnp.asarray(rows[k, 0])),
                          None, W)
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want))


def test_ingress_long_batch_handlers_and_clipping():
    """Segment rows with every built-in handler, a NOP row, and rows that
    clip at the segment end, applied in row order."""
    ctx, jctx = _ctxs()
    st, jst, rng = _states(3)
    rows = _rows([[dict(type=LONG, nwords=W, dst_addr=4, handler=1),
                   dict(type=LONG, nwords=W, dst_addr=10, handler=2),
                   dict(), dict(type=LONG, nwords=7, dst_addr=S - 3,
                                handler=3)],
                  [dict(type=LONG, nwords=W, dst_addr=S + 5, handler=1),
                   dict(type=LONG, nwords=W, dst_addr=-2, handler=4),
                   dict(type=LONG, nwords=3, dst_addr=0, handler=0),
                   dict(type=jam.make_type(jam.MEDIUM), nwords=W,
                        dst_addr=20, handler=1)],
                  [dict()] * 4])
    pay = rng.standard_normal((K, 4, W)).astype(np.float32)
    got = tgc.ingress_long_batch(ctx, st, torch.from_numpy(rows),
                                 torch.from_numpy(pay), W)
    want = [jgc.ingress_long_batch(jctx, jst[k], jnp.asarray(rows[k]),
                                   jnp.asarray(pay[k]), W) for k in range(K)]
    _assert_states(got, want)
    one = tgc.ingress_long(ctx, st, tam.decode(torch.from_numpy(rows[:, 1])),
                           torch.from_numpy(pay[:, 1]), W)
    _assert_states(one, [jgc.ingress_long(
        jctx, jst[k], jam.decode(jnp.asarray(rows[k, 1])),
        jnp.asarray(pay[k, 1]), W) for k in range(K)])


def test_ingress_stack_mixed_rows():
    """Long, user Short, reply, NOP and piggyback/defer-ack rows in one
    stack: segment, credits, deferred_acks and rx_words all match."""
    ctx, jctx = _ctxs()
    st, jst, rng = _states(4)
    short = jam.make_type(jam.SHORT)
    rows = _rows([
        [dict(type=LONG | jam.FLAG_DEFER_ACK, nwords=W, dst_addr=0,
              handler=1, token=1),
         dict(type=short, handler=jhd.H_ADD, dst_addr=5, token=9),
         dict(type=jam.make_type(jam.SHORT, asynchronous=True, reply=True),
              token=2),
         dict(type=LONG | jam.FLAG_PIGGYBACK, nwords=9, dst_addr=30,
              handler=2, pb_token=3, pb_count=2)],
        [dict(type=short, handler=jhd.H_WRITE, dst_addr=-4, token=20),
         dict(), dict(type=short, handler=jhd.H_MAX, dst_addr=7, token=0),
         dict(type=LONG | jam.FLAG_DEFER_ACK | jam.FLAG_PIGGYBACK,
              nwords=W, dst_addr=S - 8, handler=1, token=4, pb_token=4,
              pb_count=3)],
        [dict()] * 4])
    pay = rng.standard_normal((K, 4, W)).astype(np.float32)
    got = tgc.ingress_stack(ctx, st, torch.from_numpy(rows),
                            torch.from_numpy(pay), W)
    want = [jgc.ingress_stack(jctx, jst[k], jnp.asarray(rows[k]),
                              jnp.asarray(pay[k]), W) for k in range(K)]
    _assert_states(got, want)


@pytest.mark.parametrize("handler", [jhd.H_WRITE, jhd.H_ADD, jhd.H_MIN])
def test_ingress_strided(handler):
    """Disjoint strides through the unordered reference, aliasing strides
    through its block-sequential one, and a 2-row batch."""
    ctx, jctx = _ctxs()
    st, jst, rng = _states(5)
    blk, nb = 4, 5
    strided = jam.make_type(jam.LONG, strided=True)
    for stride, ordered in ((9, False), (2, True)):
        rows = _rows([[dict(type=strided, nwords=nb * blk - 3, dst_addr=a,
                            stride=stride, blk_words=blk, nblocks=nb,
                            handler=handler)] for a in (1, S - 20, -3)])
        pay = rng.standard_normal((K, nb * blk)).astype(np.float32)
        port = tgc.ingress_strided_seq if ordered else tgc.ingress_strided
        got = port(ctx, st, tam.decode(torch.from_numpy(rows[:, 0])),
                   torch.from_numpy(pay), blk, nb)
        fn = jgc.ingress_strided_seq if ordered else jgc.ingress_strided
        _assert_states(got, [fn(jctx, jst[k], jam.decode(jnp.asarray(
            rows[k, 0])), jnp.asarray(pay[k]), blk, nb) for k in range(K)])
    rows = _rows([[dict(type=strided, nwords=nb * blk, dst_addr=a,
                        stride=2, blk_words=blk, nblocks=nb, handler=handler),
                   dict(type=strided, nwords=2 * blk, dst_addr=a + 3,
                        stride=2, blk_words=blk, nblocks=2, handler=handler)]
                  for a in (0, 30, 50)])
    pay = rng.standard_normal((K, 2, nb * blk)).astype(np.float32)
    got = tgc.ingress_strided_batch(ctx, st, torch.from_numpy(rows),
                                    torch.from_numpy(pay), blk, nb)
    _assert_states(got, [jgc.ingress_strided_batch(
        jctx, jst[k], jnp.asarray(rows[k]), jnp.asarray(pay[k]), blk, nb,
        True) for k in range(K)])


def test_serve_get_batch():
    ctx, jctx = _ctxs()
    st, jst, _ = _states(6)
    get = jam.make_type(jam.MEDIUM, get=True)
    rows = _rows([[dict(type=get, src=1, dst=0, nwords=W, src_addr=3,
                        token=2, seq=0),
                   dict(type=get, src=1, dst=0, nwords=5, src_addr=S - 2,
                        token=2, seq=W)],
                  [dict(type=jam.make_type(jam.LONG, get=True), src=2, dst=1,
                        nwords=W, src_addr=40, dst_addr=8, handler=2),
                   dict()],
                  [dict(type=LONG, nwords=W), dict()]])
    got_st, got_resp, got_data = tgc.serve_get_batch(
        ctx, st, torch.from_numpy(rows), W)
    want = [jgc.serve_get_batch(jctx, jst[k], jnp.asarray(rows[k]), W)
            for k in range(K)]
    _assert_states(got_st, [w[0] for w in want])
    np.testing.assert_array_equal(got_resp.numpy(),
                                  np.stack([np.asarray(w[1]) for w in want]))
    np.testing.assert_array_equal(got_data.numpy(),
                                  np.stack([np.asarray(w[2]) for w in want]))


def test_medium_short_reply_stages():
    ctx, jctx = _ctxs()
    st, jst, rng = _states(7)
    med = jam.make_type(jam.MEDIUM)
    rows = _rows([[dict(type=med, nwords=W), dict(type=med, nwords=4)],
                  [dict(type=med, nwords=9), dict()],
                  [dict(type=LONG, nwords=W), dict()]])
    pay = rng.standard_normal((K, 2, W)).astype(np.float32)
    got_st, got = tgc.ingress_medium_batch(st, torch.from_numpy(rows),
                                           torch.from_numpy(pay), W)
    want = [jgc.ingress_medium_batch(jst[k], jnp.asarray(rows[k]),
                                     jnp.asarray(pay[k]), W)
            for k in range(K)]
    _assert_states(got_st, [w[0] for w in want])
    np.testing.assert_array_equal(got.numpy(),
                                  np.stack([np.asarray(w[1]) for w in want]))
    hdrs = _rows([[dict(type=jam.make_type(jam.SHORT), handler=jhd.H_ADD,
                        dst_addr=3, token=5, src=0, dst=1)],
                  [dict(type=jam.make_type(jam.SHORT, asynchronous=True,
                                           reply=True), token=7)],
                  [dict(type=LONG | jam.FLAG_DEFER_ACK, token=2, src=2,
                        dst=0)]])[:, 0]
    th = tam.decode(torch.from_numpy(hdrs))
    jh = [jam.decode(jnp.asarray(hdrs[k])) for k in range(K)]
    _assert_states(tgc.ingress_short(ctx, st, th),
                   [jgc.ingress_short(jctx, jst[k], jh[k]) for k in range(K)])
    _assert_states(tgc.ingress_reply(st, th),
                   [jgc.ingress_reply(jst[k], jh[k]) for k in range(K)])
    _assert_states(tgc.ingress_ack_lanes(st, th),
                   [jgc.ingress_ack_lanes(jst[k], jh[k]) for k in range(K)])
    np.testing.assert_array_equal(
        tgc.auto_reply(th).numpy(),
        np.stack([np.asarray(jgc.auto_reply(jh[k])) for k in range(K)]))
