"""The port's Shoal ops on 8 kernels against the JAX package's.

The JAX reference runs every case once, in one subprocess with 8
emulated CPU devices (``python tests/test_torch_parity.py OUT.npz``
writes its states); the port runs the same program source on the CPU
along its kernel axis.  Every PgasState field and every delivered
buffer must be equal (tolerance: none), and the port's exchange count
must equal the reference's collective-permute count for the case
(BENCH_comm.json ``current.comm``: acked put_long 2 at 1 and 4
segments, async put_long 1, acked 4-segment get_medium 2).
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
ODD = [(i, (i + 1) % N) for i in range(1, N, 2)]     # 1->2, ..., 7->0
SMALL = 64                                           # bytes: 16-word MTU


def _quickstart(ops, hd, ctx, st, p):
    st = ops.put_long(ctx, st, p, RING, dst_addr=0, token=1)
    st = ops.wait_replies(ctx, st, token=1, n=1)
    st = ops.put_long(ctx, st, p * 0 + 1, RING, dst_addr=0,
                      handler=hd.H_ADD, token=2)
    st = ops.wait_replies(ctx, st, token=2, n=1)
    st = ops.barrier(ctx, st)
    st, fetched = ops.get_medium(ctx, st, RING, src_addr=0, nwords=4,
                                 token=3)
    st = ops.wait_replies(ctx, st, token=3, n=1)
    return st, (fetched,)


def _signals(ops, hd, ctx, st, p):
    st = ops.put_short(ctx, st, RING, handler=hd.H_ADD, arg=3, token=5)
    st = ops.wait_replies(ctx, st, token=5, n=4)
    st, got = ops.put_medium(ctx, st, p[..., :8], RING, token=6)
    st = ops.wait_replies(ctx, st, token=6, n=1)
    st, mem = ops.put_medium(ctx, st, None, RING, from_segment_addr=10,
                             nwords=20, asynchronous=True)
    return st, (got, mem)


def _put_long(asynchronous):
    def prog(ops, hd, ctx, st, p):
        st = ops.put_long(ctx, st, p, RING, dst_addr=3, token=1,
                          asynchronous=asynchronous)
        return st, ()
    return prog


def _get_medium(ops, hd, ctx, st, p):
    st, got = ops.get_medium(ctx, st, RING, src_addr=5, nwords=64, token=2)
    st = ops.wait_replies(ctx, st, token=2, n=1)
    return st, (got,)


def _strided(stride, handler_name):
    def prog(ops, hd, ctx, st, p):
        st = ops.put_long_strided(ctx, st, p, RING, 5, stride, blk_words=4,
                                  nblocks=6, token=1,
                                  handler=getattr(hd, handler_name))
        st = ops.wait_replies(ctx, st, token=1, n=1)
        return st, ()
    return prog


def _multi_and_get_long(ops, hd, ctx, st, p):
    me = ctx.my_id()
    st = ops.put_long_multi(ctx, st, [(p[..., :8], EVEN, 0),
                                      (p[..., 8:16], ODD, 8)],
                            tokens=[1, 2])
    st = ops.wait_replies(ctx, st, 1 + me % 2, 1)
    st = ops.get_long(ctx, st, RING, src_addr=0, nwords=20, dst_addr=40,
                      token=4)
    st = ops.wait_replies(ctx, st, token=4, n=1)
    return st, ()


RING2 = [(i, (i + 2) % N) for i in range(N)]        # 0->2, 1->3, ...


def _put_past_end(ops, hd, ctx, st, p):
    st = ops.put_long(ctx, st, p[..., :12], RING,
                      dst_addr=ctx.segment_words - 5, token=1)
    st = ops.wait_replies(ctx, st, token=1, n=1)
    return st, ()


def _get_past_end(ops, hd, ctx, st, p):
    st, got = ops.get_medium(ctx, st, RING, src_addr=ctx.segment_words - 6,
                             nwords=12, token=2)
    st = ops.wait_replies(ctx, st, token=2, n=1)
    return st, (got,)


def _tail_past_end(ops, hd, ctx, st, p):
    st = ops.put_long(ctx, st, p, RING, dst_addr=ctx.segment_words - 40,
                      token=1)
    st = ops.wait_replies(ctx, st, token=1, n=1)
    return st, ()


def _from_segment(ops, hd, ctx, st, p):
    st = ops.put_long(ctx, st, None, RING, dst_addr=40, from_segment_addr=3,
                      nwords=36, token=1)
    st = ops.wait_replies(ctx, st, token=1, n=1)
    return st, ()


def _shorts_max_min(ops, hd, ctx, st, p):
    st = ops.put_short(ctx, st, RING, handler=hd.H_MAX, arg=3, token=5)
    st = ops.put_short(ctx, st, RING, handler=hd.H_MIN, arg=-2, token=6)
    st = ops.put_short(ctx, st, RING, handler=hd.H_MAX, arg=-4, token=6,
                       asynchronous=True)
    return st, ()


def _long(handler_name, addr):
    def prog(ops, hd, ctx, st, p):
        st = ops.put_long(ctx, st, p, RING, dst_addr=addr, token=3,
                          handler=getattr(hd, handler_name))
        st = ops.wait_replies(ctx, st, token=3, n=1)
        return st, ()
    return prog


def _partial_medium(ops, hd, ctx, st, p):
    st, got = ops.put_medium(ctx, st, None, RING, from_segment_addr=7,
                             nwords=21, token=6)
    st = ops.wait_replies(ctx, st, token=6, n=1)
    return st, (got,)


def _wait_underflow(ops, hd, ctx, st, p):
    st = ops.put_long(ctx, st, p[..., :8], RING, dst_addr=0, token=7)
    st = ops.wait_replies(ctx, st, token=7, n=2)
    return st, ()


def _multi_three(ops, hd, ctx, st, p):
    me = ctx.my_id()
    st = ops.put_long_multi(ctx, st, [(p[..., :8], EVEN, 0),
                                      (p[..., 8:16], ODD, 8),
                                      (p[..., :4], RING2, 20)],
                            tokens=[1, 2, 3])
    st = ops.wait_replies(ctx, st, 1 + me % 2, 1)
    st = ops.wait_replies(ctx, st, 3, 1)
    return st, ()


def _udp(ops, hd, ctx, st, p):
    st = ops.put_long(ctx, st, p, RING, dst_addr=30)
    st, got = ops.put_medium(ctx, st, p[..., :8], RING)
    st = ops.put_long_strided(ctx, st, p[..., :12], RING, 50, 5,
                              blk_words=3, nblocks=4, handler=hd.H_ADD)
    st = ops.put_short(ctx, st, RING, handler=hd.H_ADD, arg=2, token=4)
    return st, (got,)


@dataclasses.dataclass(frozen=True)
class Case:
    prog: object
    acked: bool = True
    mtu_bytes: int = 9000
    segment_words: int = 96
    payload_words: int = 16
    exchanges: int = 2
    errors: bool = False          # the program latches an error bit


CASES = {
    "quickstart": Case(_quickstart, segment_words=64, payload_words=4,
                       exchanges=6),
    "signals": Case(_signals, exchanges=5),
    "put_long-acked-1seg": Case(_put_long(False), mtu_bytes=SMALL),
    "put_long-acked-4seg": Case(_put_long(False), mtu_bytes=SMALL,
                                payload_words=64),
    "put_long-async-1seg": Case(_put_long(True), acked=False,
                                mtu_bytes=SMALL, exchanges=1),
    "put_long-async-4seg": Case(_put_long(True), acked=False,
                                mtu_bytes=SMALL, payload_words=64,
                                exchanges=1),
    "get_medium-acked-4seg": Case(_get_medium, mtu_bytes=SMALL),
    "strided-aliasing-write": Case(_strided(2, "H_WRITE"), mtu_bytes=SMALL,
                                   payload_words=24),
    "strided-aliasing-add": Case(_strided(2, "H_ADD"), mtu_bytes=SMALL,
                                 payload_words=24),
    "strided-disjoint-write": Case(_strided(6, "H_WRITE"), mtu_bytes=SMALL,
                                   payload_words=24),
    "multi-get_long": Case(_multi_and_get_long, exchanges=4),
    # the DataMover's edge lanes: addresses past the segment end, reads
    # from the segment, negative and out-of-range strides, the max/min
    # handlers, a partial last row; and the op layer's edges
    "put-past-end": Case(_put_past_end),
    "get-past-end": Case(_get_past_end),
    "put_long-tail-past-end": Case(_tail_past_end, mtu_bytes=SMALL,
                                   payload_words=64),
    "put_long-from_segment_addr": Case(_from_segment, mtu_bytes=SMALL),
    "strided-negative-write": Case(_strided(-7, "H_WRITE"), mtu_bytes=SMALL,
                                   payload_words=24),
    "strided-negative-add": Case(_strided(-2, "H_ADD"), mtu_bytes=SMALL,
                                 payload_words=24),
    "strided-out-of-range": Case(_strided(19, "H_WRITE"), mtu_bytes=SMALL,
                                 payload_words=24),
    "shorts-max-min": Case(_shorts_max_min, exchanges=5),
    "long-max": Case(_long("H_MAX", 6)),
    "long-min": Case(_long("H_MIN", 70)),
    "medium-partial-nwords": Case(_partial_medium, mtu_bytes=SMALL),
    "wait-underflow": Case(_wait_underflow, errors=True),
    "multi-three-items": Case(_multi_three, exchanges=4),
    "udp": Case(_udp, acked=False, exchanges=4),
}


def _inputs(name):
    case = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name) + 100)
    seg0 = rng.standard_normal((N, case.segment_words)).astype(np.float32)
    pay = rng.standard_normal((N, case.payload_words)).astype(np.float32)
    return seg0, pay


def _transport(runtime, case):
    base = runtime.TCP if case.acked else runtime.UDP
    return dataclasses.replace(base, max_packet_bytes=case.mtu_bytes)


def _run_reference(out_path):
    """All cases on the JAX package, 8 emulated devices; writes npz."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro import runtime
    from repro.core import handlers as hd, ops
    from repro.core.address_space import GlobalAddressSpace
    from repro.core.state import ShoalContext
    from repro.runtime.jax_compat import shard_map

    mesh = runtime.make_cpu_mesh(N, ("kernel",))
    spec = P(("kernel",))
    out = {}
    for name, case in CASES.items():
        ctx = ShoalContext(mesh=mesh, axes=("kernel",),
                           transport=_transport(runtime, case),
                           segment_words=case.segment_words)
        gas = GlobalAddressSpace(ctx)
        seg0, pay = _inputs(name)

        def inner(st, p, case=case, ctx=ctx):
            st = jax.tree.map(lambda x: x[0], st)
            st, extras = case.prog(ops, hd, ctx, st, p[0])
            return (jax.tree.map(lambda x: x[None], st),
                    tuple(e[None] for e in extras))

        fn = jax.jit(shard_map(inner, mesh=mesh, in_specs=(spec, spec),
                               out_specs=(spec, spec)))
        st, extras = fn(gas.make_global_state(seg0.reshape(-1)),
                        jnp.asarray(pay))
        for f in dataclasses.fields(st):
            out[f"{name}/{f.name}"] = np.asarray(getattr(st, f.name))
        for i, e in enumerate(extras):
            out[f"{name}/extra{i}"] = np.asarray(e)
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("parity") / "reference.npz"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ,
               XLA_FLAGS=f"--xla_force_host_platform_device_count={N}",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(repo, "src"))
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           str(path)], env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(path))


@pytest.mark.parametrize("name", list(CASES))
def test_ops_match_reference(reference, name):
    import torch

    from repro_torch import runtime
    from repro_torch.core import handlers as hd, ops
    from repro_torch.core.address_space import GlobalAddressSpace
    from repro_torch.core.state import ShoalContext, state_to_numpy

    case = CASES[name]
    ctx = ShoalContext(N, _transport(runtime, case), case.segment_words,
                       device="cpu")
    seg0, pay = _inputs(name)
    st = GlobalAddressSpace(ctx).make_global_state(seg0.reshape(-1))
    st, extras = case.prog(ops, hd, ctx, st, torch.from_numpy(pay))
    got = state_to_numpy(st)
    for f, arr in got.items():
        np.testing.assert_array_equal(arr, reference[f"{name}/{f}"],
                                      err_msg=f"{name}: {f}")
    for i, e in enumerate(extras):
        np.testing.assert_array_equal(
            e.numpy(), reference[f"{name}/extra{i}"],
            err_msg=f"{name}: extra{i}")
    assert ctx.exchanges == case.exchanges, (name, ctx.exchanges)
    assert bool(got["error"].any()) == case.errors, (name, got["error"])


if __name__ == "__main__":
    _run_reference(sys.argv[1])
