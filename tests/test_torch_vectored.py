"""The port's vectored Long put on 8 kernels against the JAX package's.

The JAX reference runs every case once, in one subprocess with 8
emulated CPU devices (``python tests/test_torch_vectored.py OUT.npz``
writes its states, its collective-permute counts and the exception each
refused call raised); the port runs the same program source on the CPU
along its kernel axis.  Every PgasState field must be equal (tolerance:
none; bfloat16 segments compare through float32, which holds them
exactly), the port's exchange count must equal the reference's
collective-permute count (a 32-bit vectored put: 2 acked, 1 async; a
bfloat16 one ships header, address list and payload apart: 4 and 3),
and a refused call must raise the reference's exception class.
"""

import builtins
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, strategies as st

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_reference import N, run_reference, spmd_run  # noqa: E402

RING = [(i, (i + 1) % N) for i in range(N)]


def _vec(sizes, addrs, *, asynchronous=False, handler="H_WRITE", token=1,
         wait=True):
    """Blocks cut from the payload, in order; ``addrs`` is a list or a
    function of ``ctx`` (per-kernel addresses)."""
    def prog(ops, hd, ctx, st, p):
        blocks, off = [], 0
        for w in sizes:
            blocks.append(p[..., off:off + w])
            off += w
        dst = addrs(ctx) if callable(addrs) else list(addrs)
        st = ops.put_long_vectored(ctx, st, blocks, RING, dst, token=token,
                                   handler=getattr(hd, handler),
                                   asynchronous=asynchronous)
        if wait and ctx.transport.acked and not asynchronous:
            st = ops.wait_replies(ctx, st, token, 1)
        return st
    return prog


@dataclasses.dataclass(frozen=True)
class Case:
    prog: object
    acked: bool = True
    mtu_bytes: int = 9000
    segment_words: int = 96
    payload_words: int = 16
    dtype: str = "float32"
    exchanges: int | None = None     # the recorded target, where one is


SIZES = (4, 7, 3)
BLK64 = (64,) * 34                  # 2176 payload + 34 address words


CASES = {
    "ragged-acked": Case(_vec(SIZES, (0, 20, 40)), exchanges=2),
    "ragged-async": Case(_vec(SIZES, (0, 20, 40), asynchronous=True),
                         exchanges=1),
    "ragged-udp": Case(_vec(SIZES, (5, 30, 60)), acked=False, exchanges=1),
    "uniform-34x64": Case(_vec(BLK64, [67 * i for i in range(34)]),
                          segment_words=2304, payload_words=2176,
                          exchanges=2),
    "uniform-34x64-async": Case(
        _vec(BLK64, [67 * i for i in range(34)], asynchronous=True),
        segment_words=2304, payload_words=2176, exchanges=1),
    "bf16-acked": Case(_vec(SIZES, (0, 20, 40)), dtype="bfloat16"),
    "bf16-async": Case(_vec(SIZES, (0, 20, 40), asynchronous=True),
                       dtype="bfloat16"),
    "bf16-34x64": Case(_vec(BLK64, [67 * i for i in range(34)]),
                       segment_words=2304, payload_words=2176,
                       dtype="bfloat16"),
    "per-kernel-addrs-add": Case(
        _vec(SIZES, lambda ctx: [0, ctx.my_id() * 5 + 16, 60],
             handler="H_ADD")),
    "max-handler": Case(_vec(SIZES, (2, 30, 70), handler="H_MAX")),
    "past-end": Case(_vec((4, 7), (0, 93))),
    "one-block": Case(_vec((9,), (5,))),
    # per-kernel addresses are not known when the call is made, so the
    # alias check cannot see this overlap: the blocks land in order and
    # the later one wins
    "runtime-overlap": Case(
        _vec((4, 4), lambda ctx: [0, ctx.my_id() * 0 + 2])),
    "small-mtu": Case(_vec((6, 6), (0, 10)), mtu_bytes=64),
}


def _refusals():
    """name -> program that must raise before anything ships."""
    return {
        "count-mismatch": _vec((4, 4), (0, 8, 16)),
        "over-mtu": _vec((10, 6), (0, 20)),       # 16 + 2 > 16 words
        "alias-duplicate": _vec((4, 4), (8, 8)),
        "alias-overlap": _vec((4, 4), (0, 3)),
    }


def _inputs(name):
    case = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name) + 300)
    seg0 = rng.standard_normal((N, case.segment_words)).astype(np.float32)
    pay = rng.standard_normal((N, case.payload_words)).astype(np.float32)
    return seg0, pay


def _transport(runtime, case):
    base = runtime.TCP if case.acked else runtime.UDP
    return dataclasses.replace(base, max_packet_bytes=case.mtu_bytes)


def _run_reference(out_path):
    import jax.numpy as jnp

    from repro import runtime
    from repro.core import handlers as hd, ops
    from repro.core.address_space import GlobalAddressSpace
    from repro.core.state import ShoalContext

    mesh = runtime.make_cpu_mesh(N, ("kernel",))
    out = {}
    for name, case in CASES.items():
        ctx = ShoalContext(mesh=mesh, axes=("kernel",),
                           transport=_transport(runtime, case),
                           segment_words=case.segment_words)
        seg0, pay = _inputs(name)
        dt = getattr(jnp, case.dtype)
        st0 = GlobalAddressSpace(ctx).make_global_state(seg0.reshape(-1))
        st0 = dataclasses.replace(st0, segment=st0.segment.astype(dt))

        def fn(st, p, case=case, ctx=ctx):
            return case.prog(ops, hd, ctx, st, p.astype(dt)), ()

        st, _, cps, _ = spmd_run(mesh, fn, st0, jnp.asarray(pay))
        for f in dataclasses.fields(st):
            v = np.asarray(getattr(st, f.name))
            out[f"{name}/{f.name}"] = v.astype(np.float32) \
                if f.name == "segment" else v
        out[f"{name}/cps"] = np.asarray(cps)
    for name, prog in _refusals().items():
        ctx = ShoalContext(mesh=mesh, axes=("kernel",),
                           transport=dataclasses.replace(
                               runtime.TCP, max_packet_bytes=64),
                           segment_words=64)
        st0 = GlobalAddressSpace(ctx).make_global_state()
        try:
            spmd_run(mesh, lambda st, p: (prog(ops, hd, ctx, st, p), ()),
                     st0, jnp.zeros((N, 16), jnp.float32))
            raised = "nothing"
        except Exception as e:          # the class is what is compared
            raised = type(e).__name__
        out[f"refusal/{name}"] = np.asarray(raised)
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(__file__,
                         tmp_path_factory.mktemp("vectored") / "ref.npz")


def _port(name):
    from repro_torch import runtime
    from repro_torch.core import handlers as hd, ops
    from repro_torch.core.address_space import GlobalAddressSpace
    from repro_torch.core.state import ShoalContext, replace

    case = CASES[name]
    ctx = ShoalContext(N, _transport(runtime, case), case.segment_words,
                       device="cpu")
    seg0, pay = _inputs(name)
    dt = getattr(torch, case.dtype)
    st = GlobalAddressSpace(ctx).make_global_state(seg0.reshape(-1))
    st = replace(st, segment=st.segment.to(dt))
    st = case.prog(ops, hd, ctx, st, torch.from_numpy(pay).to(dt))
    return ctx, st


@pytest.mark.parametrize("name", list(CASES))
def test_vectored_put_matches_reference(reference, name):
    from repro_torch.core.state import state_to_numpy

    ctx, st = _port(name)
    got = state_to_numpy(replace_segment_f32(st))
    for f, arr in got.items():
        np.testing.assert_array_equal(arr, reference[f"{name}/{f}"],
                                      err_msg=f"{name}: {f}")
    assert ctx.exchanges == int(reference[f"{name}/cps"]), \
        (name, ctx.exchanges, int(reference[f"{name}/cps"]))
    case = CASES[name]
    if case.exchanges is not None:
        assert ctx.exchanges == case.exchanges
    assert not got["error"].any()


def replace_segment_f32(st):
    from repro_torch.core.state import replace

    return replace(st, segment=st.segment.float())


@pytest.mark.parametrize("name", list(_refusals()))
def test_vectored_refusals_match_reference(reference, name):
    from repro_torch import runtime
    from repro_torch.core import handlers as hd, ops
    from repro_torch.core.state import ShoalContext

    ctx = ShoalContext(N, dataclasses.replace(runtime.TCP,
                                              max_packet_bytes=64), 64,
                       device="cpu")
    want = str(reference[f"refusal/{name}"])
    assert want != "nothing", name
    with pytest.raises(getattr(ops, want, None)
                       or getattr(builtins, want)) as info:
        _refusals()[name](ops, hd, ctx, ctx.make_state(), torch.zeros(N, 16))
    assert type(info.value).__name__ == want
    assert ctx.exchanges == 0          # refused before anything shipped


def test_vectored_addresses_as_a_tensor():
    """A ``(K, B)`` address tensor is the same put as a list of ``(K,)``
    columns."""
    from repro_torch.core import ops
    from repro_torch.core.state import ShoalContext

    pay = torch.randn(N, 11, generator=torch.Generator().manual_seed(4))
    addrs = torch.stack([torch.arange(N) * 2, torch.arange(N) * 2 + 30],
                        dim=1)
    outs = []
    for dst in (addrs, [addrs[:, 0], addrs[:, 1]]):
        ctx = ShoalContext(N, segment_words=64, device="cpu")
        outs.append(ops.put_long_vectored(
            ctx, ctx.make_state(), [pay[:, :4], pay[:, 4:]], RING, dst,
            token=2).segment)
    assert torch.equal(outs[0], outs[1])


@settings(max_examples=8, deadline=None)
@given(st.lists(st.integers(1, 9), min_size=1, max_size=6),
       st.integers(0, 7), st.booleans())
def test_vectored_equals_block_by_block_puts(sizes, gap, asynchronous):
    """Property: one vectored put of disjoint ragged blocks leaves the
    state B separate Long puts of the same blocks leave (credits: one
    per message), in 2 exchanges (1 async) instead of 2B (B)."""
    from repro_torch.core import ops
    from repro_torch.core.state import ShoalContext, state_to_numpy

    addrs, a = [], 3
    for w in sizes:
        addrs.append(a)
        a += w + gap
    seg_words = a + 8
    pay = torch.randn(N, sum(sizes),
                      generator=torch.Generator().manual_seed(len(sizes)))
    blocks, off = [], 0
    for w in sizes:
        blocks.append(pay[:, off:off + w])
        off += w
    ctx_v = ShoalContext(N, segment_words=seg_words, device="cpu")
    st_v = ops.put_long_vectored(ctx_v, ctx_v.make_state(), blocks, RING,
                                 addrs, token=3, asynchronous=asynchronous)
    ctx_b = ShoalContext(N, segment_words=seg_words, device="cpu")
    st_b = ctx_b.make_state()
    for b, dst in zip(blocks, addrs):
        st_b = ops.put_long(ctx_b, st_b, b, RING, dst, token=3,
                            asynchronous=asynchronous)
    v, b = state_to_numpy(st_v), state_to_numpy(st_b)
    np.testing.assert_array_equal(v["segment"], b["segment"])
    np.testing.assert_array_equal(v["rx_words"], b["rx_words"])
    np.testing.assert_array_equal(v["tx_words"], b["tx_words"])
    want_credits = 0 if asynchronous else 1
    assert (v["credits"][:, 3] == want_credits).all()
    assert ctx_v.exchanges == (1 if asynchronous else 2)
    assert ctx_b.exchanges == len(sizes) * (1 if asynchronous else 2)


if __name__ == "__main__":
    _run_reference(sys.argv[1])
