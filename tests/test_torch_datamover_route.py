"""The two DataMover designs, decided and modelled on the CPU.

``kernels.am_pack`` has two designs of the GAScore's DataMover: the
Hopper design (``csrc/am_pack_sm90.cu``: a gather tiled over the card,
and a scatter on the same grid whose every word has one writer that
applies the word's lanes in block order)
and the simple design (``csrc/am_pack.cu``).  Both run only on the card
(``tests/test_torch_cuda.py``); here ``datamover_kernel_for``'s routes,
``datamover_plan``'s grids, the build registry and the counters are
checked without one, the Hopper scatter's ownership partition is
replayed in plain Python -- a word one block alone touches applied by
that block, a shared word folded in block order by its first toucher,
the threads in any order -- and held bitwise to the plain version, and
the plain versions
take 16-bit words as the JAX package's TPU kernels (in interpret mode)
and GAScore do.  Tolerance: none (every comparison is bitwise).
"""

import importlib
import random
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, strategies as st

from repro.core import am as jam, gascore as jgc
from repro.core.state import PgasState as JaxState, ShoalContext as JaxCtx
from repro.kernels.am_pack.am_pack import am_pack_pallas, am_unpack_pallas
from repro.runtime.topology import make_cpu_mesh
from repro_torch.core import handlers as hd
from repro_torch.kernels import LAUNCH_COUNTERS, _build
from repro_torch.kernels import am_pack as dm

dmm = importlib.import_module("repro_torch.kernels.am_pack.am_pack")

WORDS = [torch.float32, torch.int32, torch.bfloat16, torch.float16]
HALF = (torch.bfloat16, torch.float16)


# -- routes ------------------------------------------------------------------

def _measured_route(op, K, B, W, dtype):
    """The routes of scripts/datamover_sweep.py's table in PERF.md,
    written out: where the Hopper design won both turns at every layout
    measured.  The sweep extended to W 4 and 8, ragged rows and gated
    duplicate rows (the message layer's shapes) kept these bounds: no
    point routed to the Hopper design lost, and the simple design's
    wins stayed below them."""
    if dtype in HALF:
        return "sm90"
    if op == "gather":
        wide = W >= 1536 or (W >= 1024 and K * B >= 320)
        return "sm90" if wide and B <= 65535 else "simple"
    if B > 2048:
        return "simple"
    return "sm90" if B >= 4 or K * B <= 2 \
        or W >= {1: 1536, 2: 1024, 3: 1024}[B] else "simple"


@pytest.mark.parametrize("dtype", WORDS)
@pytest.mark.parametrize("op", ["gather", "scatter"])
@pytest.mark.parametrize("B", [1, 2, 3, 4, 40, dmm.STAGE_MAX_B,
                               dmm.STAGE_MAX_B + 1, dmm.GRID_MAX + 1])
def test_datamover_kernel_for_routes_by_shape(op, B, dtype):
    """Gathers of rows of at least 1536 lanes (1024 in 320 rows or
    more), scatters of 4 to 2048 blocks per kernel row or of 1-3 blocks
    of wide rows or in 1-2 rows to the Hopper design, where
    scripts/datamover_sweep.py measured it faster; the rest of 32-bit
    words to the simple design; 16-bit words to the Hopper design
    whatever the shape.  A pure function of its arguments."""
    for W in (1, 4, 8, 64, 1023, 1024, 1535, 1536, 2176, 2250):
        for K in (1, 2, 8, 200):
            want = _measured_route(op, K, B, W, dtype)
            assert dm.datamover_kernel_for(op, K, B, W, dtype) == want, \
                (K, W)
            assert dm.datamover_kernel_for(op, K, B, W, dtype) == want


@pytest.mark.parametrize("op,K,B,W", [
    ("gather", 8, 2, 2250),      # Jacobi's halo egress
    ("scatter", 8, 2, 2250),     # Jacobi's halo ingress
    ("gather", 8, 4, 2250),      # a 4-segment get, put or its service
    ("scatter", 8, 4, 2250),
    ("scatter", 8, 1, 2250),     # a 1-segment put's ingress
    ("gather", 8, 2, 2240),      # the ops phase's strided put, egress
    ("scatter", 8, 70, 64),      # and ingress
])
def test_main_path_shapes_take_the_hopper_design(op, K, B, W):
    assert dm.datamover_kernel_for(op, K, B, W, torch.float32) == "sm90"


@pytest.mark.parametrize("op,K,B,W,route", [
    ("scatter", 8, 1024, 4, "sm90"),     # the 1024-send mailbox flush
    ("gather", 8, 1, 2176, "sm90"),      # the vectored put's egress row
    ("scatter", 8, 34, 64, "sm90"),      # its 34 blocks
    ("gather", 8, 34, 64, "simple"),     # its ragged blocks, received
    ("gather", 8, 16, 2250, "sm90"),     # the reliable put's egress
    ("scatter", 8, 32, 2250, "sm90"),    # its stack with duplicates
    ("gather", 8, 4, 4, "simple"),       # bench_faults' put, egress
    ("scatter", 8, 8, 4, "sm90"),        # and its stack
])
def test_message_layer_shapes_take_the_measured_design(op, K, B, W, route):
    """The message layer's float32 shapes take the design
    chip_smoke.py's phase 7 timed faster in the same call."""
    assert dm.datamover_kernel_for(op, K, B, W, torch.float32) == route


def test_routes_refuse_what_no_design_moves():
    with pytest.raises(ValueError, match="op must be"):
        dm.datamover_kernel_for("copy", 1, 1, 8, torch.float32)
    with pytest.raises(TypeError, match="float32, int32, bfloat16"):
        dm.datamover_plan("gather", 1, 1, 8, torch.float64)
    with pytest.raises(ValueError, match="B and K up to 65535"):
        dm.datamover_plan("gather", 1, dmm.GRID_MAX + 1, 8, torch.float32)
    meta = torch.zeros(2, 8, dtype=torch.bfloat16, device="meta")
    with pytest.raises(TypeError, match="simple DataMover kernels"):
        dmm._route("scatter", meta, 1, 8, "simple")
    with pytest.raises(ValueError, match="kernel must be one of"):
        dmm._route("gather", meta, 1, 8, "library")
    assert dmm._route("gather", meta, 1, 8, None) == "sm90"


# -- plans -------------------------------------------------------------------

def _unit_lanes(u, h, W, V):
    """``unit_lanes`` of the source: unit 0 the ragged head [0, h), unit
    u >= 1 the V lanes from h + (u - 1) V, cut at W."""
    lo = 0 if u == 0 else min(W, h + (u - 1) * V)
    return lo, min(W, h + u * V)


@pytest.mark.parametrize("op,K,B,W,dtype", [
    ("gather", 8, 2, 2250, torch.float32),
    ("gather", 8, 4, 2250, torch.bfloat16),
    ("scatter", 8, 2, 2250, torch.float32),
    ("scatter", 8, 40, 64, torch.int32),
    ("scatter", 3, 5, 37, torch.float16),
    ("gather", 1, 1, 1, torch.float32),
    ("gather", 2, 3, 1000, torch.int32),
    ("scatter", 1, 1, 9000, torch.bfloat16),
])
def test_plan_units_cover_every_lane_once(op, K, B, W, dtype):
    """The plan's CTAs, units and threads cover every lane of every
    packet row exactly once; every whole unit starts on a 16-byte
    boundary of the packet row; the grid fills the card where the rows
    allow and a CTA is a multiple of a warp."""
    plan = dm.datamover_plan(op, K, B, W, dtype)
    V = 16 // dtype.itemsize
    units = plan.threads * plan.vt if op == "gather" else plan.threads // V
    per_thread = units // plan.vt
    for row in range(min(K * B, 5)):
        h = (V - row * W % V) % V
        seen = np.zeros(W, np.int64)
        lanes = np.zeros(W, np.int64)
        for tile in range(plan.tiles):
            for t in range(plan.vt):
                for thread in range(per_thread):
                    u = (tile * plan.vt + t) * per_thread + thread
                    lo, hi = _unit_lanes(u, h, W, V)
                    seen[lo:hi] += 1
                    if hi - lo == V:
                        assert (row * W + lo) % V == 0
            if op == "scatter":      # one lane a thread, from the tile's
                first = _unit_lanes(tile * units, h, W, V)[0]
                last = _unit_lanes(tile * units + units - 1, h, W, V)[1]
                assert last - first <= plan.threads
                lanes[first:last] += 1
        assert (seen == 1).all(), (row, np.flatnonzero(seen != 1)[:8])
        assert op == "gather" or (lanes == 1).all()
    assert plan.ctas == K * B * plan.tiles
    assert plan.ctas >= dmm.SM_COUNT or plan.threads == 32 \
        or units * V >= W + V
    assert 32 <= plan.threads <= 1024 and plan.threads % 32 == 0
    assert not plan.walk


@pytest.mark.parametrize("dtype", WORDS)
def test_plan_walks_large_scatters_in_order(dtype):
    B = dmm.STAGE_MAX_B + 1
    plan = dm.datamover_plan("scatter", 8, B, 2250, dtype)
    assert plan.walk and plan.ctas == 8 and plan.threads == 1024
    assert dm.datamover_plan("scatter", 8, B, 40, dtype).threads == 64
    staged = dm.datamover_plan("scatter", 8, B - 1, 40, dtype)
    assert not staged.walk and staged.ctas == 8 * (B - 1) * staged.tiles
    assert dm.datamover_plan("scatter", dmm.GRID_MAX + 1, B, 40,
                             dtype).walk       # the walk's grid is K


def test_build_registry_counters_and_profiler_names():
    """The Hopper design builds as its own library; each design counts
    its own launches; chip_smoke.py's ``device_ms`` tells the kernels
    apart by a substring of their device-side names, so no simple
    kernel's name may sit inside a Hopper kernel's."""
    assert _build.SOURCES["am_pack_sm90"].name == "am_pack_sm90.cu"
    assert _build.library_path("am_pack_sm90").name.startswith(
        "libam_pack_sm90")
    assert LAUNCH_COUNTERS["datamover_gather"] is dmm.launch_gather
    assert LAUNCH_COUNTERS["datamover_scatter"] is dmm.launch_scatter
    assert LAUNCH_COUNTERS["datamover_gather_sm90"] is dmm.launch_gather_sm90
    assert LAUNCH_COUNTERS["datamover_scatter_sm90"] \
        is dmm.launch_scatter_sm90
    names = {n: re.findall(r"__global__ void\s+(\w+)\(",
                           _build.SOURCES[n].read_text())
             for n in ("am_pack", "am_pack_sm90")}
    assert names == {"am_pack": ["gather_kernel", "scatter_kernel"],
                     "am_pack_sm90": ["gather_sm90_kernel",
                                      "scatter_sm90_kernel",
                                      "scatter_walk_sm90_kernel",
                                      "empty_sm90_kernel"]}
    for simple in names["am_pack"]:
        assert not any(simple in n for n in names["am_pack_sm90"])
    text = _build.SOURCES["am_pack_sm90"].read_text()
    assert "src/repro/kernels/am_pack/am_pack.py:41" in text
    assert "src/repro/kernels/am_pack/am_pack.py:58" in text


# -- the Hopper scatter's ownership partition, replayed ----------------------

def _headers(addr, nwords, handler, active, S, W):
    """``stage_headers`` of the source: (addr, lo, hi, op) per block,
    [lo, hi) the in-segment words of its live lanes (empty if dead)."""
    out = []
    for a, nw, h, act in zip(addr, nwords, handler, active):
        op = min(max(h, 0), 4)
        lo, hi = max(a, 0), min(a + min(nw, W), S)
        if not act or op == 0 or hi <= lo:
            lo = hi = 0
        out.append((a, lo, hi, op))
    return out


def replay_scatter(seg, pay, addr, nwords, handler, active, rng):
    """The Hopper scatter, thread by thread: a block that meets no other
    applies its own words; in a block that meets another, the thread of
    a word's first toucher folds every touching block's lane on it in
    block order (the segment word read only if a read-modify-write lane
    comes before every write lane), and later touchers skip it.  The
    words' threads run in a random order.  Returns the new segment and,
    per kernel row, how many threads wrote each word."""
    K, S = seg.shape
    B, W = pay.shape[1], pay.shape[2]
    out = seg.clone()
    writes = []
    for k in range(K):
        hdr = _headers(addr[k].tolist(), nwords[k].tolist(),
                       handler[k].tolist(), active[k].tolist(), S, W)

        def touches(c, w):
            return hdr[c][1] <= w < hdr[c][2]

        meets = [any(c != b and max(hdr[b][1], hdr[c][1])
                     < min(hdr[b][2], hdr[c][2]) for c in range(B))
                 for b in range(B)]
        threads = [(b, w) for b in range(B)
                   for w in range(hdr[b][1], hdr[b][2])]
        rng.shuffle(threads)
        count = {}
        for b, w in threads:
            if meets[b] and any(touches(c, w) for c in range(b)):
                continue                     # an earlier block's word
            chain = [b] + [c for c in range(b + 1, B)
                           if meets[b] and touches(c, w)]
            v = None
            for c in chain:
                a, _, _, op = hdr[c]
                p = pay[k, c, w - a:w - a + 1]
                if op == 1:
                    v = p.clone()
                else:
                    v = hd.DEFAULT_TABLE.dispatch(
                        op, out[k, w:w + 1] if v is None else v, p)
            out[k, w:w + 1] = v
            count[w] = count.get(w, 0) + 1
        writes.append(count)
    return out, writes


def _layout(rng, layout, K, B, W, S):
    """addr, nwords, handler, active ``(K, B)`` int32 of one layout."""
    if layout == "disjoint":
        start = rng.integers(0, max(S - B * W, 1))
        addr = np.tile(start + W * np.arange(B), (K, 1))
    elif layout == "aliasing":
        addr = np.tile(rng.integers(0, S // 2) + rng.integers(
            1, max(W // 2, 2)) * np.arange(B), (K, 1))
    elif layout == "edges":
        addr = rng.integers(-W - 2, S + 2, (K, B))
    else:
        addr = rng.integers(-3, S, (K, B))
    nwords = rng.integers(-1, W + 3, (K, B))
    handler = rng.integers(-1, 7, (K, B))
    active = (rng.random((K, B)) < 0.8).astype(np.int32)
    return [torch.from_numpy(np.asarray(x, np.int32))
            for x in (addr, nwords, handler, active)]


def _words(rng, shape, dtype):
    if dtype == torch.int32:
        x = rng.integers(-100, 100, shape)
        x.reshape(-1)[::7] = 2 ** 31 - 3                 # add wraps
        return torch.from_numpy(x.astype(np.int32))
    x = (rng.standard_normal(shape) * 4).astype(np.float32)
    x.reshape(-1)[::11] = np.nan                         # max/min keep NaN
    return torch.from_numpy(x).to(dtype)


def _same(got, want):
    """Bitwise equal, but a NaN matches any NaN: the CPU's vectorised
    max/min gives a NaN every bit set, a one-word op keeps the operand's
    bits."""
    bits = {4: torch.int32, 2: torch.int16}[got.element_size()]
    if got.dtype == torch.int32:
        return torch.equal(got, want)
    nan = got.isnan()
    return torch.equal(nan, want.isnan()) and torch.equal(
        got.view(bits)[~nan], want.view(bits)[~nan])


@pytest.mark.parametrize("layout", ["disjoint", "aliasing", "edges",
                                    "random"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32,
                                   torch.bfloat16])
@settings(max_examples=6, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1))
def test_ownership_partition_gives_the_in_order_result(dtype, layout, seed):
    """The Hopper scatter gives every live word one writer, and together
    its threads give ``datamover_scatter_ref``'s in-order result bitwise
    (NaN for NaN), in any order of the threads."""
    rng = np.random.default_rng(seed)
    K, B, W = 2, int(rng.integers(1, 7)), int(rng.integers(1, 9))
    S = int(rng.integers(W + 1, 48))
    addr, nwords, handler, active = _layout(rng, layout, K, B, W, S)
    seg = _words(rng, (K, S), dtype)
    pay = _words(rng, (K, B, W), dtype)
    want = dm.datamover_scatter_ref(seg.clone(), pay, addr, nwords, handler,
                                    active)
    got, writes = replay_scatter(seg, pay, addr, nwords, handler, active,
                                 random.Random(seed))
    assert _same(got, want)
    for k, count in enumerate(writes):           # one writer per word
        assert set(count.values()) <= {1}
        live = _headers(addr[k].tolist(), nwords[k].tolist(),
                        handler[k].tolist(), active[k].tolist(), S, W)
        assert set(count) == {w for _, lo, hi, _ in live
                              for w in range(lo, hi)}


# -- 16-bit words on the CPU path, held to the JAX package --------------------

def _bf(x, dtype):
    return torch.from_numpy(x).to(dtype)


@pytest.mark.parametrize("dtype", HALF)
@settings(max_examples=8, deadline=None)
@given(addr=st.integers(0, 50), stride=st.integers(-8, 40),
       blk=st.integers(1, 8), nblocks=st.integers(1, 6))
def test_am_pack_16bit_matches_pallas(dtype, addr, stride, blk, nblocks):
    rng = np.random.default_rng(addr * 64 + blk)
    seg = rng.standard_normal(512).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float16
    want = am_pack_pallas(jnp.asarray(seg, jdt), addr, stride=stride,
                          blk_words=blk, nblocks=nblocks, interpret=True)
    got = dm.am_pack(_bf(seg, dtype), addr, stride, blk, nblocks)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("dtype", HALF)
@settings(max_examples=8, deadline=None)
@given(addr=st.integers(0, 50), stride=st.integers(-8, 40),
       blk=st.integers(1, 8), nblocks=st.integers(1, 6))
def test_am_unpack_16bit_matches_pallas_in_order(dtype, addr, stride, blk,
                                                 nblocks):
    """Aliasing strides: the last block wins in 16-bit words too."""
    rng = np.random.default_rng(addr * 64 + blk + 1)
    seg = rng.standard_normal(512).astype(np.float32)
    pay = rng.standard_normal(blk * nblocks).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float16
    want = am_unpack_pallas(jnp.asarray(seg, jdt), jnp.asarray(pay, jdt),
                            addr, stride=stride, blk_words=blk,
                            nblocks=nblocks, interpret=True)
    got = dm.am_unpack(_bf(seg, dtype), _bf(pay, dtype), addr, stride, blk,
                       nblocks)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def _jax_ctx(S):
    return JaxCtx(mesh=make_cpu_mesh(1, ("kernel",)), axes=("kernel",),
                  segment_words=S)


@pytest.mark.parametrize("handler", range(hd.NUM_BUILTIN))
@pytest.mark.parametrize("stride", [3, 11])
def test_bf16_scatter_handlers_match_strided_ingress(handler, stride):
    """Every built-in handler on bfloat16 words through the in-order
    scatter, per kernel row, against the reference's block-sequential
    strided ingress (as tests/test_torch_kernels.py does for float32
    and int32); stride 3 < blk 8 aliases, blocks run past the end."""
    S, blk, nblocks, K = 64, 8, 6, 3
    rng = np.random.default_rng(handler * 16 + stride)
    seg = (rng.standard_normal((K, S)) * 8).astype(np.float32)
    pay = (rng.standard_normal((K, nblocks * blk)) * 8).astype(np.float32)
    addr = np.array([2, 20, 40], np.int32)
    nwords = np.array([nblocks * blk, nblocks * blk - 5, 17], np.int32)
    got = dm.datamover_scatter(
        _bf(seg, torch.bfloat16),
        _bf(pay, torch.bfloat16).reshape(K, nblocks, blk),
        torch.from_numpy(addr[:, None] + stride * np.arange(nblocks)).int(),
        torch.from_numpy(np.clip(nwords[:, None] - blk * np.arange(nblocks),
                                 0, blk)).int(),
        torch.full((K, nblocks), handler, dtype=torch.int32),
        torch.ones((K, nblocks), dtype=torch.int32))
    ctx = _jax_ctx(S)
    for k in range(K):
        stt = JaxState.make(S, jnp.bfloat16)
        stt = jgc.dataclasses_replace(
            stt, segment=jnp.asarray(seg[k], jnp.bfloat16))
        hdr = jam.decode(jam.encode(
            type=jam.make_type(jam.LONG, strided=True), nwords=nwords[k],
            dst_addr=addr[k], stride=stride, blk_words=blk, nblocks=nblocks,
            handler=handler))
        want = jgc.ingress_strided_seq(ctx, stt, hdr,
                                       jnp.asarray(pay[k], jnp.bfloat16),
                                       blk, nblocks)
        np.testing.assert_array_equal(got[k].float().numpy(),
                                      np.asarray(want.segment, np.float32))


@pytest.mark.parametrize("dtype", HALF)
def test_16bit_gather_matches_egress_batch(dtype):
    """Memory-sourced rows in 16-bit words, a row past the segment end,
    a negative address and masked lanes, against the reference egress."""
    S, W, K = 96, 16, 2
    rng = np.random.default_rng(3)
    seg = rng.standard_normal((K, S)).astype(np.float32)
    src_addr = np.array([[0, 40, 90], [-3, 16, 200]], np.int32)
    nwords = np.array([[16, 9, 16], [16, 0, 5]], np.int32)
    got = dm.datamover_gather(_bf(seg, dtype),
                              torch.from_numpy(src_addr).clamp(0, S),
                              torch.from_numpy(nwords), W)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float16
    ctx = _jax_ctx(S)
    for k in range(K):
        stt = jgc.dataclasses_replace(JaxState.make(S, jdt),
                                      segment=jnp.asarray(seg[k], jdt))
        rows = jam.encode_batch(3, nwords=jnp.asarray(nwords[k]),
                                src_addr=jnp.asarray(src_addr[k]))
        want = jgc.egress_batch(ctx, stt, rows, None, W)
        assert got.dtype == dtype
        np.testing.assert_array_equal(got[k].float().numpy(),
                                      np.asarray(want, np.float32))
