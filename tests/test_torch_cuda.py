"""The port's CUDA kernels and its main path on a CUDA card (skipped
without one).  Run on a machine with an H100 and nvcc:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: DataMover exact, bitwise where masked lanes hold NaN/inf,
both designs against the plain version and each other (NaN for NaN
where a max/min scatter meets NaN words: the plain version's NaN bits
depend on torch's path);
Jacobi float32 1e-6, bfloat16 2e-2 (the kernel and its plain version
round the same operations, so in practice both are exact); the Jacobi
app 1e-5 against the single-grid reference, as examples/jacobi_stencil.py
holds the JAX app; both ring kernels bitwise against their plain version
and each other (same adds in the same order, rounded to the type after
each); flash
attention float32 2e-3, bfloat16 3e-2 against its plain version (the
reference's tolerances, tests/test_kernels.py:109), the Hopper flash
kernel also against the simple one at 3e-2, and bitwise against itself
where only future keys change, the simple kernel also at MLA's q·k 192
/ v 128, both kernels also with causal=False at a key length of its
own (cross-attention's prompt pass), the simple kernel also at head
dim 256 (recurrentgemma's MQA prompt pass, four threads a row); the
float32 Hopper flash kernel (TF32) at 2e-3 against the plain version
and the simple kernel at each of its head-dim pairs, causal and not,
ragged, on the views ``mla`` and a fused projection make, and bitwise
against itself where only future keys change; both Hopper flash kernels
on the padded route (head dims below a tile) at the tolerance of the
type, causal and at T 129 and T 1; the
engines on the
card serve the CPU run's tokens exactly (float32 tinyllama-smoke, whose
flash calls take the exact float32 kernel there -- ``exact_flash`` --,
and a small MLA model at deepseek-v2's head dims); the
float32 trainer on the card within 1e-5 of its CPU run (TF32 off), its
all-reduced rows bitwise equal and its int32 ring sums exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels import (am_pack as dm, gascore_dma as gd,
                                 jacobi as jk, launch_counts,
                                 reset_launch_counts)
from test_torch_parity import CASES as PARITY_CASES, _inputs, _transport

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the card with -m cuda")
    return torch.device("cuda")


@pytest.fixture
def exact_flash(monkeypatch):
    """The models' flash route on the card through the exact float32
    kernel (``flash.cu``, ``kernel="simple"``) for float32 inputs: the
    float32 Hopper kernel rounds its products to TF32, which a check of
    the card against the CPU at 1e-5 with TF32 off does not allow (that
    kernel is held to its plain version at 2e-3 by the flash tests);
    the smoke configs' float32 models (dh 16) run their prompt passes on
    the exact kernel under it."""
    from repro_torch.kernels import attention as fa
    from repro_torch.models import attention as attn

    def exact(q, k, v, causal=True):
        if q.device.type == "cuda" and q.dtype == torch.float32:
            return fa.flash_attention_cuda(q, k, v, kernel="simple",
                                           causal=causal)
        return fa.flash_attention(q, k, v, causal=causal)

    monkeypatch.setattr(attn, "flash_attention", exact)


def _i32(rows, device):
    return torch.tensor(rows, dtype=torch.int32, device=device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
@pytest.mark.parametrize("stride", [5, 40])
def test_datamover_kernels_match_plain(cuda, dtype, stride):
    gen = torch.Generator().manual_seed(stride)
    K, S, B, W = 4, 1024, 24, 32
    seg = (torch.randn(K, S, generator=gen) * 8).to(dtype).to(cuda)
    pay = (torch.randn(K, B, W, generator=gen) * 8).to(dtype).to(cuda)
    addr = _i32([[b * stride - 3 + k for b in range(B)] for k in range(K)],
                cuda)
    nwords = _i32([[W - (b + k) % 4 for b in range(B)] for k in range(K)],
                  cuda)
    handler = _i32([[(b * 3 + k) % 5 for b in range(B)] for k in range(K)],
                   cuda)
    active = _i32([[int((b + k) % 5 != 1) for b in range(B)]
                   for k in range(K)], cuda)
    got = dm.datamover_scatter(seg.clone(), pay, addr, nwords, handler,
                               active)
    want = dm.datamover_scatter_ref(seg.clone(), pay, addr, nwords, handler,
                                    active)
    assert torch.equal(got, want)
    rows = dm.datamover_gather(seg, addr, nwords, W)
    assert torch.equal(rows, dm.datamover_gather_ref(seg, addr, nwords, W))


@pytest.mark.parametrize("addr,stride,blk,nblocks", [(50, 7, 8, 4),
                                                     (60, 3, 8, 3),
                                                     (10, -6, 4, 4)])
def test_am_pack_unpack_at_segment_edge(cuda, addr, stride, blk, nblocks):
    """Blocks past either end slide back inside the segment on the card
    as in the plain versions (held to the TPU kernels on the CPU)."""
    gen = torch.Generator().manual_seed(addr)
    seg = torch.randn(64, generator=gen)
    pay = torch.randn(blk * nblocks, generator=gen)
    assert torch.equal(dm.am_pack(seg.to(cuda), addr, stride, blk,
                                  nblocks).cpu(),
                       dm.am_pack_ref(seg, addr, stride, blk, nblocks))
    assert torch.equal(dm.am_unpack(seg.to(cuda), pay.to(cuda), addr, stride,
                                    blk, nblocks).cpu(),
                       dm.am_unpack_ref(seg, pay, addr, stride, blk, nblocks))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.bfloat16, 2e-2)])
def test_jacobi_kernel_matches_plain(cuda, dtype, tol):
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(300, 257, generator=gen).to(cuda, dtype)
    torch.testing.assert_close(jk.jacobi_step(x).float(),
                               jk.jacobi_step_ref(x).float(), rtol=tol,
                               atol=tol)
    pad = torch.randn(6, 34, 257, generator=gen).to(cuda, dtype)
    torch.testing.assert_close(jk.jacobi_band_step(pad).float(),
                               jk.jacobi_band_ref(pad).float(), rtol=tol,
                               atol=tol)


def test_jacobi_app_on_the_card(cuda):
    from repro_torch.apps.jacobi import JacobiApp, jacobi_reference
    from repro_torch.runtime import TCP

    grid = np.random.default_rng(0).standard_normal((256, 256)).astype(
        np.float32)
    reset_launch_counts()
    app = JacobiApp(n=256, kernels=8, iters=10, device=cuda,
                    transport=dataclasses.replace(TCP, max_packet_bytes=256))
    out = app.run(grid)
    counts = launch_counts()
    np.testing.assert_allclose(out, jacobi_reference(grid, 10, cuda),
                               rtol=0, atol=1e-5)
    assert app.ctx.exchanges == 2 * 10 + 2
    assert counts["jacobi_sweep"] == 10
    # a 256-word halo row is 4 packets of 64 words: the narrow gather
    # takes the simple design, the 4-block scatter the Hopper one
    routes = {op: dm.datamover_kernel_for(op, 8, 4, 64, torch.float32)
              for op in ("gather", "scatter")}
    assert routes == {"gather": "simple", "scatter": "sm90"}
    assert counts["datamover_gather"] > 0 \
        and counts["datamover_scatter_sm90"] > 0
    assert counts["datamover_gather_sm90"] == counts["datamover_scatter"] \
        == 0


def test_gather_masked_lanes_bitwise(cuda):
    """Lanes past nwords over NaN, +-inf and negative words: the kernel
    multiplies every lane by its mask, as its plain version does."""
    gen = torch.Generator().manual_seed(5)
    seg = torch.randn(4, 256, generator=gen)
    seg[:, ::5] = float("nan")
    seg[:, 1::5] = float("inf")
    seg[:, 2::5] = -float("inf")
    seg[:, 3::5] = -seg[:, 3::5].abs() - 1
    seg = seg.to(cuda)
    addr = _i32([[b * 40 + k for b in range(6)] for k in range(4)], cuda)
    nwords = _i32([[(b * 7 + k) % 33 for b in range(6)] for k in range(4)],
                  cuda)
    got = dm.datamover_gather(seg, addr, nwords, 32)
    want = dm.datamover_gather_ref(seg, addr, nwords, 32)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert bool(got.isnan().any()) and bool((got.view(torch.int32)
                                             == -2 ** 31).any())


# -- the two DataMover designs ---------------------------------------------

DM_WORDS = [torch.float32, torch.int32, torch.bfloat16, torch.float16]
DM_LAYOUTS = {          # layout: (K, B, W, S)
    "disjoint": (4, 24, 40, 2048),
    "aliasing": (4, 40, 64, 2048),
    "edges": (4, 16, 300, 1024),
    "random": (3, 9, 33, 200),
    "jacobi": (8, 2, 2250, 8192),        # Jacobi's halo egress / ingress
    "micro": (8, 4, 2250, 9064),         # a 4-segment put, get, service
    "strided": (8, 70, 64, 9064),        # the ops phase's strided ingress
}


def _dm_case(layout, dtype, seed, device, nan=False):
    """seg, pay, addr, nwords, handler, active of one layout (every
    built-in handler, an out-of-range op code, inactive blocks)."""
    K, B, W, S = DM_LAYOUTS[layout]
    rng = np.random.default_rng(seed)
    if layout in ("disjoint", "jacobi", "micro"):
        addr = np.tile(W * np.arange(B) + (S - B * W) // 3, (K, 1))
    elif layout in ("aliasing", "strided"):
        addr = np.tile(100 + 24 * np.arange(B), (K, 1))
    elif layout == "edges":
        addr = rng.integers(-W - 2, S + 2, (K, B))
    else:
        addr = rng.integers(-3, S, (K, B))
    nwords = np.clip(W - rng.integers(-2, 4, (K, B)), -1, W + 2)
    handler = rng.integers(-1, 7, (K, B))
    active = (rng.random((K, B)) < 0.85).astype(np.int32)

    def words(shape):
        if dtype == torch.int32:
            x = rng.integers(-1000, 1000, shape)
            x.reshape(-1)[::13] = 2 ** 31 - 7            # add wraps
            return torch.from_numpy(x.astype(np.int32))
        x = (rng.standard_normal(shape) * 8).astype(np.float32)
        if nan:
            x.reshape(-1)[::9] = np.nan
        return torch.from_numpy(x).to(dtype)

    ints = [torch.from_numpy(np.asarray(x, np.int32)).to(device)
            for x in (addr, nwords, handler, active)]
    return [words((K, S)).to(device), words((K, B, W)).to(device)] + ints


def _same_bits(got, want, nan_ok=False):
    bits = {4: torch.int32, 2: torch.int16}[got.element_size()]
    if not nan_ok or got.dtype == torch.int32:
        return torch.equal(got.view(bits), want.view(bits))
    nan = got.isnan()
    return torch.equal(nan, want.isnan()) and torch.equal(
        got.view(bits)[~nan], want.view(bits)[~nan])


def _designs(dtype):
    return ("sm90", "simple", None) if dtype in (torch.float32,
                                                 torch.int32) else ("sm90",
                                                                    None)


@pytest.mark.parametrize("layout", list(DM_LAYOUTS))
@pytest.mark.parametrize("dtype", DM_WORDS)
def test_datamover_designs_match_plain_and_each_other_bitwise(cuda, dtype,
                                                              layout):
    """Gather and scatter on both designs (the simple one moves 32-bit
    words only) and on ``datamover_kernel_for``'s route, bitwise equal
    to the plain version on the same inputs, so to each other."""
    seg, pay, addr, nwords, handler, active = _dm_case(layout, dtype, 7,
                                                       cuda)
    W = pay.shape[2]
    want_g = dm.datamover_gather_ref(seg, addr, nwords, W)
    want_s = dm.datamover_scatter_ref(seg.clone(), pay, addr, nwords,
                                      handler, active)
    for kernel in _designs(dtype):
        got_g = dm.datamover_gather_cuda(seg, addr, nwords, W, kernel=kernel)
        got_s = dm.datamover_scatter_cuda(seg.clone(), pay, addr, nwords,
                                          handler, active, kernel=kernel)
        assert _same_bits(got_g, want_g), ("gather", kernel)
        assert _same_bits(got_s, want_s), ("scatter", kernel)


@pytest.mark.parametrize("dtype", DM_WORDS)
def test_datamover_scatter_max_min_keep_nan(cuda, dtype):
    """NaN words through every handler: max/min propagate NaN, add and
    write carry it, on both designs (NaN for NaN: see the docstring)."""
    for layout in ("aliasing", "edges"):
        seg, pay, addr, nwords, handler, active = _dm_case(
            layout, dtype, 11, cuda, nan=True)
        want = dm.datamover_scatter_ref(seg.clone(), pay, addr, nwords,
                                        handler, active)
        for kernel in _designs(dtype):
            got = dm.datamover_scatter_cuda(seg.clone(), pay, addr, nwords,
                                            handler, active, kernel=kernel)
            assert _same_bits(got, want, nan_ok=True), (layout, kernel)


@pytest.mark.parametrize("B", [1, 2, 3, 17, 64, 65, 300, 2048, 2049])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_datamover_scatter_staged_and_walked_at_every_b(cuda, dtype, B):
    """The Hopper scatter staged (headers in shared memory, the ownership
    partition) at block counts on both sides of 32 and 64 (the bitmask's
    words), and walked (every block in order) past STAGE_MAX_B, aliasing,
    against the plain version."""
    import importlib

    dmm = importlib.import_module("repro_torch.kernels.am_pack.am_pack")
    K, W = 3, 24
    gen = torch.Generator().manual_seed(B)
    seg = (torch.randn(K, 10 * B + 64, generator=gen) * 8).to(dtype).to(
        cuda)
    pay = (torch.randn(K, B, W, generator=gen) * 8).to(dtype).to(cuda)
    addr = _i32([[50 + b * (7 + k) for b in range(B)] for k in range(K)],
                cuda)
    nwords = _i32([[W - (b + k) % 5 for b in range(B)] for k in range(K)],
                  cuda)
    handler = _i32([[(b * 3 + k) % 5 for b in range(B)] for k in range(K)],
                   cuda)
    active = _i32([[int((b + k) % 7 != 2) for b in range(B)]
                   for k in range(K)], cuda)
    want = dm.datamover_scatter_ref(seg.clone(), pay, addr, nwords, handler,
                                    active)
    plan = dmm.datamover_plan("scatter", K, B, W, dtype)
    assert plan.walk == (B > dmm.STAGE_MAX_B)
    got = seg.clone()
    dmm.launch_scatter_sm90(got, pay, addr, nwords, handler, active, plan)
    assert _same_bits(got, want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_gather_masked_lanes_bitwise_16bit(cuda, dtype):
    """The masked-lanes case in 16-bit words: NaN, +-inf and negative
    words past nwords read NaN, NaN and -0.0 (``__hmul`` by 0)."""
    gen = torch.Generator().manual_seed(6)
    seg = torch.randn(4, 256, generator=gen)
    seg[:, ::5] = float("nan")
    seg[:, 1::5] = float("inf")
    seg[:, 2::5] = -float("inf")
    seg[:, 3::5] = -seg[:, 3::5].abs() - 1
    seg = seg.to(dtype).to(cuda)
    addr = _i32([[b * 40 + k for b in range(6)] for k in range(4)], cuda)
    nwords = _i32([[(b * 7 + k) % 33 for b in range(6)] for k in range(4)],
                  cuda)
    got = dm.datamover_gather(seg, addr, nwords, 32)
    want = dm.datamover_gather_ref(seg, addr, nwords, 32)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    assert bool(got.isnan().any()) and bool((got.view(torch.int16)
                                             == -2 ** 15).any())


def test_datamover_route_shows_in_launch_counts(cuda):
    """Each call launches the design ``datamover_kernel_for`` names, once,
    and only that design's counter moves."""
    import importlib

    dmm = importlib.import_module("repro_torch.kernels.am_pack.am_pack")
    names = {("gather", "sm90"): "datamover_gather_sm90",
             ("gather", "simple"): "datamover_gather",
             ("scatter", "sm90"): "datamover_scatter_sm90",
             ("scatter", "simple"): "datamover_scatter"}
    for dtype in (torch.float32, torch.bfloat16):
        for B in (2, 4, dmm.STAGE_MAX_B, dmm.STAGE_MAX_B + 1):
            K, W = 2, 16
            seg = torch.zeros(K, 8192, dtype=dtype, device=cuda)
            pay = torch.ones(K, B, W, dtype=dtype, device=cuda)
            addr = _i32([[b * W for b in range(B)]] * K, cuda)
            ones = torch.ones_like(addr)
            for op in ("gather", "scatter"):
                reset_launch_counts()
                if op == "gather":
                    dm.datamover_gather(seg, addr, ones * W, W)
                else:
                    dm.datamover_scatter(seg, pay, addr, ones * W, ones,
                                         ones)
                route = dm.datamover_kernel_for(op, K, B, W, dtype)
                grew = {n: c for n, c in launch_counts().items() if c}
                assert grew == {names[op, route]: 1}, (op, B, dtype, grew)


@pytest.mark.parametrize("name", list(PARITY_CASES))
def test_parity_op_cases_on_the_card_match_the_cpu(cuda, name):
    """Every op program of tests/test_torch_parity.py (held there to the
    JAX package on the CPU) on a CUDA context: the state and the
    delivered buffers bit for bit as the port's CPU run, the same
    exchanges.  They cross the DataMover's edge lanes."""
    from repro_torch import runtime
    from repro_torch.core import handlers as hd, ops
    from repro_torch.core.address_space import GlobalAddressSpace
    from repro_torch.core.state import ShoalContext, state_to_numpy

    case = PARITY_CASES[name]
    runs = []
    for device in ("cpu", cuda):
        ctx = ShoalContext(8, _transport(runtime, case), case.segment_words,
                           device=device)
        seg0, pay = _inputs(name)
        st = GlobalAddressSpace(ctx).make_global_state(seg0.reshape(-1))
        st, extras = case.prog(ops, hd, ctx, st, torch.from_numpy(pay).to(
            device))
        runs.append((state_to_numpy(st), [e.cpu().numpy() for e in extras],
                     ctx.exchanges))
    (cpu, cpu_x, cpu_ex), (card, card_x, card_ex) = runs
    for f, arr in cpu.items():
        np.testing.assert_array_equal(card[f], arr, err_msg=f"{name}: {f}")
    for a, b in zip(card_x, cpu_x):
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
    assert card_ex == cpu_ex == case.exchanges


def _ring_input(K, shape, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    if dtype == torch.int32:
        return torch.randint(-127, 128, (K,) + shape, generator=gen,
                             dtype=torch.int32)
    return torch.randn((K,) + shape, generator=gen).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
@pytest.mark.parametrize("K", [8, 3])
def test_ring_kernel_matches_plain_bitwise(cuda, dtype, K):
    """Both schedules, every collective, at chunk lengths that are not
    multiples of K, of the vector width or of the tile."""
    for i, chunk in enumerate((1, 37, 130, 4096, 4099)):
        x = _ring_input(K, (chunk,), dtype, i).to(cuda)
        assert torch.equal(gd.ring_allreduce_dma(x),
                           gd.ring_allreduce_dma_ref(x)), ("dma", chunk)
        buf = _ring_input(K, (K, chunk), dtype, i + 10).to(cuda)
        for schedule, arg in ((gd.REDUCE_SCATTER, buf), (gd.ALL_GATHER, x),
                              (gd.ALL_REDUCE, buf)):
            assert torch.equal(gd.ring_collective(arg, schedule),
                               gd.ring_collective_ref(arg, schedule)), (
                schedule, chunk)


def test_collectives_on_the_card_match_the_cpu(cuda):
    """Collectives on a CUDA context: one ring launch per ring
    collective, the CPU context's results bit for bit, the same exchange
    counts."""
    from repro_torch.core import collectives as coll
    from repro_torch.core.state import ShoalContext

    x = _ring_input(8, (5, 37), torch.float32, 3)
    results, exchanges = [], []
    for device in ("cpu", cuda):
        ctx = ShoalContext(8, device=device)
        xd = x.to(device)
        reset_launch_counts()
        rs = coll.ring_reduce_scatter(ctx, xd)
        out = [coll.ring_all_reduce(ctx, xd), rs,
               coll.ring_all_gather(ctx, rs),
               coll.broadcast_from(ctx, xd, root=5),
               coll.all_to_all_vectored(ctx, xd[:, :4, :32].reshape(8, 8, 16)),
               coll.tree_barrier(ctx)]
        results.append([o.cpu() for o in out])
        exchanges.append(ctx.exchanges)
    counts = launch_counts()
    for got, want in zip(results[1], results[0]):
        assert torch.equal(got, want)
    assert exchanges == [4 * 7 + 2 * 7 + 1] * 2
    assert counts["ring_collective"] == 3 and counts["ring_allreduce_dma"] == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
@pytest.mark.parametrize("K", [2, 3, 5, 8])
def test_cluster_ring_kernel_matches_plain_and_simple_bitwise(cuda, dtype, K):
    """The cluster kernel (forced, and where ``ring_kernel_for`` routes
    to it) against the plain version and the simple kernel, all four
    schedules, chunks that are not multiples of K, of the vector width
    or of the tile; 4096 is 1 MB's chunk (32768 words / 8)."""
    reset_launch_counts()
    launches = 0
    for i, chunk in enumerate((1, 37, 130, 4096, 4099)):
        x = _ring_input(K, (chunk,), dtype, i).to(cuda)
        buf = _ring_input(K, (K, chunk), dtype, i + 10).to(cuda)
        want = gd.ring_allreduce_dma_ref(x)
        for kernel in ("sm90", "simple", None):
            assert torch.equal(gd.ring_allreduce_dma_cuda(x, kernel=kernel),
                               want), ("dma", kernel, chunk)
        launches += 1 + (gd.ring_kernel_for(K, chunk, dtype, gd.DMA)
                         == "sm90")
        for schedule, arg in ((gd.REDUCE_SCATTER, buf), (gd.ALL_GATHER, x),
                              (gd.ALL_REDUCE, buf)):
            want = gd.ring_collective_ref(arg, schedule)
            for kernel in ("sm90", "simple", None):
                assert torch.equal(gd.ring_collective_cuda(
                    arg, schedule, kernel=kernel), want), (
                        schedule, kernel, chunk)
            launches += 1 + (gd.ring_kernel_for(K, chunk, dtype, schedule)
                             == "sm90")
    assert launch_counts()["ring_cluster_sm90"] == launches


def test_collectives_on_the_card_take_the_cluster_kernel(cuda):
    """On 8 kernels the main path's small ring collectives are one launch
    each, of the kernel ``ring_kernel_for`` measured faster: the 1 MB
    reduce-scatter and all-gather and tinyllama's 2048-word norm leaf on
    the cluster kernel, the 1-word scale on the simple kernel."""
    from repro_torch.core import collectives as coll
    from repro_torch.core.state import ShoalContext

    ctx = ShoalContext(8, device=cuda)
    mb = _ring_input(8, (32768,), torch.float32, 1).to(cuda)
    norm = _ring_input(8, (2048,), torch.float32, 2).to(cuda)
    scale = _ring_input(8, (1,), torch.float32, 3).to(cuda)
    reset_launch_counts()
    rs = coll.ring_reduce_scatter(ctx, mb)
    ag = coll.ring_all_gather(ctx, rs)
    ar_norm = coll.ring_all_reduce(ctx, norm)
    counts = launch_counts()
    assert counts["ring_cluster_sm90"] == counts["ring_collective"] == 3
    ar_scale = coll.ring_all_reduce(ctx, scale)
    counts = launch_counts()
    assert counts["ring_cluster_sm90"] == 3 and counts["ring_collective"] == 4
    cpu = ShoalContext(8, device="cpu")
    want_rs = coll.ring_reduce_scatter(cpu, mb.cpu())
    assert torch.equal(rs.cpu(), want_rs)
    assert torch.equal(ag.cpu(), coll.ring_all_gather(cpu, want_rs))
    for got, v in zip((ar_norm, ar_scale), (norm, scale)):
        assert torch.equal(got.cpu(), coll.ring_all_reduce(cpu, v.cpu()))


def test_cluster_ring_kernel_refuses_rings_beyond_the_cluster(cuda):
    x = torch.zeros(200, 200, 4, device=cuda)
    with pytest.raises(ValueError, match="2 <= K <= 8"):
        gd.ring_collective_cuda(x, gd.ALL_REDUCE, kernel="sm90")
    with pytest.raises(ValueError, match="2 <= K <= 8"):
        gd.ring_allreduce_dma_cuda(torch.zeros(200, 8, device=cuda),
                                   kernel="sm90")
    # K = 200 takes the simple kernel, which holds it for dma
    reset_launch_counts()
    y = _ring_input(200, (8,), torch.float32, 4).to(cuda)
    assert torch.equal(gd.ring_allreduce_dma(y), gd.ring_allreduce_dma_ref(y))
    assert launch_counts()["ring_cluster_sm90"] == 0


def test_ring_kernel_refuses_what_it_cannot_hold(cuda):
    with pytest.raises(ValueError, match="does not fit"):
        gd.ring_collective(torch.zeros(200, 200, 4, device=cuda),
                           gd.ALL_REDUCE)
    with pytest.raises(TypeError, match="float32, bfloat16 and int32"):
        gd.ring_allreduce_dma(torch.zeros(4, 8, dtype=torch.float64,
                                          device=cuda))


# -- causal flash attention ------------------------------------------------
# Tolerances: the reference's own (tests/test_kernels.py:109), float32
# 2e-3 and bfloat16 3e-2; the kernel and its plain version sum in other
# orders and bfloat16 rounds p at other places.

def _qkv(B, S, H, K, dh, dtype, seed, device):
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn(B, S, H, dh, generator=gen)
    k = torch.randn(B, S, K, dh, generator=gen)
    v = torch.randn(B, S, K, dh, generator=gen)
    return [t.to(device, dtype) for t in (q, k, v)]


def _flash_close(got, want, dtype):
    """Within atol = rtol = tol, and within tol of the largest |want|:
    without causality, over many keys, every output is small and the
    first limit alone is as wide as the values."""
    tol = 2e-3 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * want.float().abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,K,dh", [
    (1, 1024, 32, 4, 64),           # tinyllama-1.1b's prefill
    (1, 128, 4, 4, 128),            # a reference test shape, dh 128
    (2, 256, 2, 1, 64),
])
def test_flash_kernel_matches_plain(cuda, dtype, B, S, H, K, dh):
    from repro_torch.kernels import attention as fa

    q, k, v = _qkv(B, S, H, K, dh, dtype, S + dh, cuda)
    _flash_close(fa.flash_attention(q, k, v), fa.flash_attention_ref(q, k, v),
                 dtype)


@pytest.mark.parametrize("S", [1, 2, 31, 63, 65, 200])
@pytest.mark.parametrize("dh", [16, 48, 100])
def test_flash_kernel_ragged_sequence_and_head_dim(cuda, S, dh):
    from repro_torch.kernels import attention as fa

    q, k, v = _qkv(2, S, 6, 3, dh, torch.float32, S * dh, cuda)
    _flash_close(fa.flash_attention(q, k, v), fa.flash_attention_ref(q, k, v),
                 torch.float32)


def test_flash_kernel_reads_strided_views(cuda):
    """q, k, v as views of one fused projection (no copy), and a q whose
    head dim is not contiguous."""
    from repro_torch.kernels import attention as fa

    B, S, H, K, dh = 2, 77, 4, 2, 32
    gen = torch.Generator().manual_seed(9)
    qkv = torch.randn(B, S, (H + 2 * K) * dh, generator=gen).to(cuda)
    q = qkv[..., :H * dh].view(B, S, H, dh)
    k = qkv[..., H * dh:(H + K) * dh].view(B, S, K, dh)
    v = qkv[..., (H + K) * dh:].view(B, S, K, dh)
    assert not q.is_contiguous()
    _flash_close(fa.flash_attention(q, k, v), fa.flash_attention_ref(q, k, v),
                 torch.float32)
    qt = q.transpose(-1, -2).contiguous().transpose(-1, -2)
    assert qt.stride(-1) != 1
    _flash_close(fa.flash_attention(qt, k, v),
                 fa.flash_attention_ref(q, k, v), torch.float32)


def test_flash_kernel_counts_launches_and_refuses(cuda):
    from repro_torch.kernels import attention as fa

    q, k, v = _qkv(1, 40, 4, 2, 16, torch.bfloat16, 1, cuda)
    reset_launch_counts()
    for _ in range(3):
        fa.flash_attention(q, k, v)
    assert launch_counts()["flash_attention"] == 3
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(*_qkv(1, 8, 2, 2, 257, torch.float32, 2, cuda))
    with pytest.raises(TypeError, match="float32/bfloat16"):
        fa.flash_attention(*_qkv(1, 8, 2, 2, 8, torch.float64, 2, cuda))
    with pytest.raises(ValueError, match="H % K"):
        fa.flash_attention(*_qkv(1, 8, 3, 2, 8, torch.float32, 2, cuda))
    assert launch_counts()["flash_attention"] == 3


# -- the Hopper flash kernel (csrc/flash_sm90.cu) ----------------------------
# The wrapper sends every bfloat16 input at dh 64 / 128 on TMA's 16-byte
# grid to it (tests/test_torch_flash_dispatch.py); the same tolerance.

@pytest.mark.parametrize("S", [1, 63, 64, 65, 190, 903, 1024])
@pytest.mark.parametrize("dh,H,K", [
    (64, 8, 8), (64, 8, 2), (64, 8, 1),        # GQA groups 1, 4 and 8
    (128, 8, 8), (128, 8, 2), (128, 8, 1),
])
def test_flash_sm90_matches_plain_and_simple_kernel(cuda, S, dh, H, K):
    from repro_torch.kernels import attention as fa

    B = 2 if S < 512 else 1
    q, k, v = _qkv(B, S, H, K, dh, torch.bfloat16, S * dh + K, cuda)
    assert fa.flash_kernel_for(q, k, v) == "sm90"
    reset_launch_counts()
    got = fa.flash_attention(q, k, v)
    simple = fa.flash_attention_cuda(q, k, v, kernel="simple")
    counts = launch_counts()
    assert (counts["flash_attention"], counts["flash_attention_sm90"]) \
        == (2, 1)
    _flash_close(got, fa.flash_attention_ref(q, k, v), torch.bfloat16)
    _flash_close(got, simple, torch.bfloat16)


@pytest.mark.parametrize("dh", [64, 128])
def test_flash_sm90_is_causal(cuda, dh):
    """Changing keys and values from position t on leaves every row
    before t bitwise unchanged (t inside a 64-row block, so the diagonal
    tile's mask is what keeps them out)."""
    from repro_torch.kernels import attention as fa

    B, S, H, K, t = 2, 300, 4, 2, 137
    q, k, v = _qkv(B, S, H, K, dh, torch.bfloat16, 5, cuda)
    k2, v2 = k.clone(), v.clone()
    k2[:, t:] = 8 * torch.randn_like(k2[:, t:].float()).bfloat16()
    v2[:, t:] = -v2[:, t:] + 3
    out, out2 = fa.flash_attention(q, k, v), fa.flash_attention(q, k2, v2)
    assert launch_counts()["flash_attention_sm90"] >= 2
    assert torch.equal(out[:, :t], out2[:, :t])
    assert not torch.equal(out[:, t:], out2[:, t:])


def test_flash_sm90_reads_fused_projection_views(cuda):
    """q, k, v as views of one fused bfloat16 projection (no copy): TMA
    reads them through their strides."""
    from repro_torch.kernels import attention as fa

    B, S, H, K, dh = 2, 150, 4, 2, 64
    gen = torch.Generator().manual_seed(17)
    qkv = torch.randn(B, S, (H + 2 * K) * dh + 8, generator=gen).to(
        cuda, torch.bfloat16)[..., 8:]
    q = qkv[..., :H * dh].view(B, S, H, dh)
    k = qkv[..., H * dh:(H + K) * dh].view(B, S, K, dh)
    v = qkv[..., (H + K) * dh:].view(B, S, K, dh)
    assert not q.is_contiguous() and fa.flash_kernel_for(q, k, v) == "sm90"
    _flash_close(fa.flash_attention(q, k, v), fa.flash_attention_ref(q, k, v),
                 torch.bfloat16)


def test_flash_launch_counters_show_which_kernel_ran(cuda):
    from repro_torch.kernels import attention as fa

    def counts():
        c = launch_counts()
        return c["flash_attention"], c["flash_attention_sm90"]

    bf16 = _qkv(1, 70, 4, 2, 64, torch.bfloat16, 3, cuda)
    reset_launch_counts()
    fa.flash_attention(*bf16)
    assert counts() == (1, 1)
    fa.flash_attention(*_qkv(1, 70, 4, 2, 64, torch.float32, 3, cuda))
    assert counts() == (2, 1)
    # a 200-byte head-dim row: off TMA's grid, the simple kernel
    fa.flash_attention(*_qkv(1, 70, 4, 2, 100, torch.bfloat16, 3, cuda))
    assert counts() == (3, 1)
    fa.flash_attention_cuda(*bf16, kernel="simple")
    assert counts() == (4, 1)
    with pytest.raises(ValueError, match="sm90 kernel does not take"):
        fa.flash_attention_cuda(
            *_qkv(1, 70, 4, 2, 64, torch.float32, 3, cuda), kernel="sm90")
    with pytest.raises(ValueError, match="kernel must be one of"):
        fa.flash_attention_cuda(*bf16, kernel="library")
    assert counts() == (4, 1)


# -- the simple flash kernel at MLA's head dims (q·k 192, v 128) ------------
# deepseek-v2's prompt pass: q = cat(q_nope 128, q_rope 64), k = cat(k_nope,
# the shared rope key broadcast to every head), v 128; same tolerances.

def _mla_qkv(B, S, H, K, dtype, seed, device):
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn(B, S, H, 192, generator=gen)
    k = torch.randn(B, S, K, 192, generator=gen)
    v = torch.randn(B, S, K, 128, generator=gen)
    return [t.to(device, dtype) for t in (q, k, v)]


@pytest.mark.parametrize("S", [1, 63, 64, 1000, 1024])
@pytest.mark.parametrize("H,K", [(8, 8), (8, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_at_mla_head_dims_matches_plain(cuda, S, H, K, dtype):
    """The routed kernel: the Hopper one of the type (``flash_sm90.cu``
    in bfloat16, ``flash_sm90_f32.cu`` in float32)."""
    from repro_torch.kernels import attention as fa

    B = 2 if S < 512 else 1
    bf16 = dtype == torch.bfloat16
    q, k, v = _mla_qkv(B, S, H, K, dtype, S + K, cuda)
    assert fa.flash_kernel_for(q, k, v) == ("sm90" if bf16 else "sm90_f32")
    reset_launch_counts()
    got = fa.flash_attention(q, k, v)
    counts = launch_counts()
    assert (counts["flash_attention"], counts["flash_attention_sm90"],
            counts["flash_attention_sm90_f32"]) == (1, int(bf16),
                                                    int(not bf16))
    assert got.shape == (B, S, H, 128) and got.dtype == dtype
    _flash_close(got, fa.flash_attention_ref(q, k, v), dtype)


def test_flash_kernel_at_deepseek_v2_prefill_shape(cuda):
    """B 1 x S 1024 x H 128 (K 128), bfloat16: chip_smoke.py's shape."""
    from repro_torch.kernels import attention as fa

    q, k, v = _mla_qkv(1, 1024, 128, 128, torch.bfloat16, 5, cuda)
    _flash_close(fa.flash_attention(q, k, v), fa.flash_attention_ref(q, k, v),
                 torch.bfloat16)


def test_flash_kernel_at_mla_head_dims_reads_cat_and_expand_views(cuda):
    """k built as ``mla`` builds it (a cat of per-head keys and the shared
    rope key broadcast), k as an ``expand`` of one head (stride 0), q a
    slice of a wider projection, v a view of a fused k / v row."""
    from repro_torch.kernels import attention as fa

    B, S, H = 2, 77, 4
    gen = torch.Generator().manual_seed(23)
    q_wide = torch.randn(B, S, H, 200, generator=gen).to(cuda)
    q = q_wide[..., 4:196]
    kv = torch.randn(B, S, H, 128 + 128, generator=gen).to(cuda)
    kr = torch.randn(B, S, 64, generator=gen).to(cuda)
    k = torch.cat([kv[..., :128], kr[:, :, None].expand(B, S, H, 64)], -1)
    v = kv[..., 128:]
    assert not q.is_contiguous() and not v.is_contiguous()
    for kk in (k, k[:, :, :1].expand(B, S, H, 192)):
        _flash_close(fa.flash_attention(q, kk, v),
                     fa.flash_attention_ref(q, kk, v), torch.float32)


def test_flash_at_mla_head_dims_refuses_sm90_and_other_pairs(cuda):
    """The bfloat16 Hopper kernel takes MLA's (192, 128) in bfloat16, not
    in float32; every kernel refuses the other unequal pairs."""
    from repro_torch.kernels import attention as fa

    q, k, v = _mla_qkv(1, 70, 4, 4, torch.bfloat16, 3, cuda)
    reset_launch_counts()
    with pytest.raises(ValueError, match="sm90 kernel does not take"):
        fa.flash_attention_cuda(*(t.float() for t in (q, k, v)),
                                kernel="sm90")
    gen = torch.Generator().manual_seed(4)
    for dqk, dv in ((256, 128), (128, 192), (192, 64)):
        qq, kk, vv = (torch.randn(1, 8, 2, n, generator=gen).to(
            cuda, torch.bfloat16) for n in (dqk, dqk, dv))
        for kernel in (None, "sm90", "simple"):
            with pytest.raises(ValueError, match="head dim"):
                fa.flash_attention_cuda(qq, kk, vv, kernel=kernel)
    assert launch_counts()["flash_attention"] == 0
    got = fa.flash_attention_cuda(q, k, v, kernel="sm90")
    assert (launch_counts()["flash_attention"],
            launch_counts()["flash_attention_sm90"]) == (1, 1)
    fa.flash_attention_cuda(q, k, v, kernel="simple")
    assert (launch_counts()["flash_attention"],
            launch_counts()["flash_attention_sm90"]) == (2, 1)
    _flash_close(got, fa.flash_attention_ref(q, k, v), torch.bfloat16)


def test_mla_engine_on_the_card_serves_the_cpu_tokens(cuda):
    """A small MLA model at deepseek-v2's head dims (nope 128, rope 64,
    v 128; float32) served on the card gives the CPU run's tokens; every
    prompt pass of every layer launches the float32 Hopper kernel (TF32
    products), decode (the absorbed form) never."""
    from repro_torch.models.attention import MLADims
    from repro_torch.models.model import ModelConfig, build_model
    from repro_torch.serving import Request, ServeEngine

    cfg = ModelConfig(name="mla-card", family="dense", n_layers=2,
                      d_model=64, n_heads=2, n_kv_heads=2, d_ff=128,
                      vocab=128, mla=MLADims(q_lora=32, kv_lora=16),
                      dtype=torch.float32)
    params = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    prompts = [[3, 14, 15, 9, 2], [7, 8], [30, 2, 9], [11, 12, 13, 5]]
    outs = {}
    for device in ("cpu", cuda):
        engine = ServeEngine(build_model(cfg, device=device),
                             _to(params, device), lanes=2, slots=16)
        reset_launch_counts()
        done = engine.run([Request(i, np.asarray(p, np.int32), 4)
                           for i, p in enumerate(prompts)])
        outs[str(device)] = {r.rid: r.out for r in done}
        counts = launch_counts()
    assert outs["cpu"] == outs[str(cuda)]
    assert (counts["flash_attention"], counts["flash_attention_sm90"],
            counts["flash_attention_sm90_f32"]) == (
        len(prompts) * cfg.n_layers, 0, len(prompts) * cfg.n_layers)


def test_engine_on_the_card_serves_the_cpu_tokens(cuda, exact_flash):
    """tinyllama-smoke (float32) served on the card through the exact
    flash kernel (``exact_flash``) gives the CPU run's tokens; every
    prompt pass launches the kernel once per layer, decode never."""
    from repro_torch import configs
    from repro_torch.models.model import build_model
    from repro_torch.serving import Request, ServeEngine

    prompts = [[3, 14, 15, 9, 2], [7, 8], [30, 2, 9], [11, 12, 13, 5],
               [1, 4], [22, 40, 8]]
    max_new = [5, 3, 4, 5, 3, 4]
    cfg = configs.reduced("tinyllama-1.1b")
    params = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    outs = {}
    for device in ("cpu", cuda):
        model = build_model(cfg, device=device)
        engine = ServeEngine(model, _to(params, device), lanes=2, slots=16)
        reset_launch_counts()
        done = engine.run([Request(i, np.asarray(p, np.int32), m)
                           for i, (p, m) in enumerate(zip(prompts,
                                                          max_new))])
        outs[str(device)] = {r.rid: r.out for r in done}
        flash = launch_counts()["flash_attention"]
    assert outs["cpu"] == outs[str(cuda)]
    assert flash == len(prompts) * cfg.n_layers


@pytest.mark.parametrize("B,S,H,K,dh", [
    (1, 1024, 12, 2, 128),          # qwen2-1.5b's prefill
    (1, 1024, 32, 32, 128),         # deepseek-7b's (MHA: group size 1)
    (1, 1024, 24, 24, 64),          # musicgen-medium's
])
def test_flash_sm90_at_the_served_model_shapes(cuda, B, S, H, K, dh):
    from repro_torch.kernels import attention as fa

    q, k, v = _qkv(B, S, H, K, dh, torch.bfloat16, H + dh, cuda)
    assert fa.flash_kernel_for(q, k, v) == "sm90"
    reset_launch_counts()
    got = fa.flash_attention(q, k, v)
    assert launch_counts()["flash_attention_sm90"] == 1
    _flash_close(got, fa.flash_attention_ref(q, k, v), torch.bfloat16)


def test_qwen2_at_full_width_serves_through_the_sm90_kernel(cuda):
    """qwen2-1.5b at its published width, cut to 2 layers (bfloat16, qkv
    bias, tied embeddings): every prompt pass of every layer takes the
    Hopper kernel (the bias must not move q/k/v off its TMA grid), and
    one prefill's logits agree with the same prefill through the plain
    version within 3e-2 of the largest |logit|."""
    from repro_torch import configs
    from repro_torch.kernels import attention as fa
    from repro_torch.models import attention as attn
    from repro_torch.models.model import build_model
    from repro_torch.serving import Request, ServeEngine

    cfg = dataclasses.replace(configs.full("qwen2-1.5b"), n_layers=2)
    model = build_model(cfg, device=cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (300, 129, 64)]
    reset_launch_counts()
    done = ServeEngine(model, params, lanes=2, slots=512).run(
        [Request(i, p, 4) for i, p in enumerate(prompts)])
    counts = launch_counts()
    assert sorted(len(r.out) for r in done) == [4, 4, 4]
    assert counts["flash_attention"] == counts["flash_attention_sm90"] \
        == len(prompts) * cfg.n_layers
    tokens = torch.as_tensor(prompts[0].astype(np.int64), device=cuda)[None]
    got, _ = model.prefill(params, {"tokens": tokens},
                           model.make_cache(1, 512))
    real = attn.flash_attention
    attn.flash_attention = fa.flash_attention_ref
    try:
        want, _ = model.prefill(params, {"tokens": tokens},
                                model.make_cache(1, 512))
    finally:
        attn.flash_attention = real
    top = want.float().abs().max().item()
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= 3e-2 * top


def test_musicgen_smoke_on_the_card_matches_the_cpu(cuda, monkeypatch,
                                                     exact_flash):
    """musicgen-smoke (float32, frame embeddings): a prefill through the
    flash kernel and two decode steps on the card within 1e-5 of the CPU
    run (TF32 off)."""
    from repro_torch import configs
    from repro_torch.models.model import build_model

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = configs.reduced("musicgen-medium")
    params = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    frames = torch.randn(2, 40, cfg.d_model, generator=gen) * 0.02
    steps = torch.randn(2, 2, 1, cfg.d_model, generator=gen) * 0.02
    logits = {}
    for device in ("cpu", cuda):
        model = build_model(cfg, device=device)
        p = _to(params, device)
        cache = model.make_cache(2, 64)
        reset_launch_counts()
        out, cache = model.prefill(p, {"embeddings": frames.to(device)},
                                   cache)
        got = [out.cpu()]
        pos = torch.tensor([40, 40], device=device)
        for i in range(2):
            out, cache = model.decode_step(p, cache, steps[i].to(device),
                                           pos + i)
            got.append(out.cpu())
        logits[str(device)] = torch.stack(got)
        flash = launch_counts()["flash_attention"]
    assert flash == cfg.n_layers
    torch.testing.assert_close(logits[str(cuda)], logits["cpu"], rtol=1e-5,
                               atol=1e-5)


# -- non-causal flash attention (cross-attention's prompt pass) --------------
# S text tokens over T image tokens, every key valid; the same tolerances.
# A ragged T leaves the Hopper kernel's last key tile zero-filled past T:
# unmasked, those keys would score 0 and take a share of the softmax,
# past the limit at T 129 (one key into a tile of 32, 64 or 128) and T 1.

def _cross_qkv(B, S, T, H, K, dh, dtype, seed, device):
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn(B, S, H, dh, generator=gen)
    k = torch.randn(B, T, K, dh, generator=gen)
    v = torch.randn(B, T, K, dh, generator=gen)
    return [t.to(device, dtype) for t in (q, k, v)]


@pytest.mark.parametrize("T", [1, 129, 1000, 1600])
@pytest.mark.parametrize("S", [7, 64, 1024])
@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_noncausal_flash_kernels_match_plain(cuda, T, S, dh, dtype):
    """The routed kernel (the Hopper one of the type) and the simple one
    forced, both with causal=False, against the plain version; the
    route and the non-causal counter."""
    from repro_torch.kernels import attention as fa

    B = 2 if S < 512 else 1
    q, k, v = _cross_qkv(B, S, T, 8, 2, dh, dtype, S + T + dh, cuda)
    bf16 = dtype == torch.bfloat16
    assert fa.flash_kernel_for(q, k, v) == ("sm90" if bf16 else "sm90_f32")
    reset_launch_counts()
    got = fa.flash_attention(q, k, v, causal=False)
    simple = fa.flash_attention_cuda(q, k, v, kernel="simple", causal=False)
    counts = launch_counts()
    assert (counts["flash_attention"], counts["flash_attention_sm90"],
            counts["flash_attention_sm90_f32"],
            counts["flash_attention_noncausal"]) \
        == (2, int(bf16), int(not bf16), 2)
    want = fa.flash_attention_ref(q, k, v, causal=False)
    assert got.shape == (B, S, 8, dh)
    _flash_close(got, want, dtype)
    _flash_close(simple, want, dtype)


def test_noncausal_flash_at_the_cross_attention_prompt_shape(cuda):
    """llama-3.2-vision-90b's cross-attention prompt pass: B 4 x S 1024
    x H 64 (K 8) over T 1600 image tokens, dh 128, bf16 (chip_smoke.py's
    shape), on both kernels."""
    from repro_torch.kernels import attention as fa

    q, k, v = _cross_qkv(4, 1024, 1600, 64, 8, 128, torch.bfloat16, 41,
                         cuda)
    want = fa.flash_attention_ref(q, k, v, causal=False)
    for kernel in ("sm90", "simple"):
        _flash_close(fa.flash_attention_cuda(q, k, v, kernel=kernel,
                                             causal=False), want,
                     torch.bfloat16)


@pytest.mark.parametrize("dh", [64, 128])
def test_noncausal_flash_sm90_reads_every_key(cuda, dh):
    """Changing the last key and value (in the ragged last tile) changes
    the first query's row: no causal mask is left on."""
    from repro_torch.kernels import attention as fa

    q, k, v = _cross_qkv(1, 130, 1000, 4, 2, dh, torch.bfloat16, 3, cuda)
    k2, v2 = k.clone(), v.clone()
    k2[:, -1] = 4 * q[:, 0, :2]
    v2[:, -1] = 8
    out = fa.flash_attention(q, k, v, causal=False)
    out2 = fa.flash_attention(q, k2, v2, causal=False)
    assert not torch.equal(out[:, 0], out2[:, 0])
    _flash_close(out2, fa.flash_attention_ref(q, k2, v2, causal=False),
                 torch.bfloat16)


def test_flash_refuses_another_key_length_when_causal(cuda):
    from repro_torch.kernels import attention as fa

    q, k, v = _cross_qkv(1, 16, 20, 4, 2, 64, torch.bfloat16, 2, cuda)
    reset_launch_counts()
    for kernel in (None, "sm90", "simple"):
        with pytest.raises(ValueError, match="causal attention needs"):
            fa.flash_attention_cuda(q, k, v, kernel=kernel)
    assert launch_counts()["flash_attention"] == 0
    fa.flash_attention_cuda(q, k, v, causal=False)
    assert (launch_counts()["flash_attention"],
            launch_counts()["flash_attention_noncausal"]) == (1, 1)


def test_vlm_smoke_on_the_card_matches_the_cpu(cuda, monkeypatch,
                                                exact_flash):
    """llama-vision-smoke (float32, the cross layer's gate opened): a
    prefill (4 causal and 1 non-causal flash launch, all on the simple
    kernel at dh 16) and two decode steps re-attending the image
    features on the card within 1e-5 of the CPU run (TF32 off)."""
    from repro_torch import configs
    from repro_torch.models.model import build_model

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = configs.reduced("llama-3.2-vision-90b")
    params = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    params["segments"][0]["b4_cross"]["xattn"]["gate"].fill_(0.75)
    gen = torch.Generator().manual_seed(1)
    feats = torch.randn(2, cfg.n_image_tokens, cfg.d_model, generator=gen)
    toks = torch.randint(0, cfg.vocab, (2, 40), generator=gen)
    logits = {}
    for device in ("cpu", cuda):
        model = build_model(cfg, device=device)
        p = _to(params, device)
        f = feats.to(device)
        cache = model.make_cache(2, 64)
        reset_launch_counts()
        out, cache = model.prefill(p, {"tokens": toks.to(device),
                                       "image_feats": f}, cache)
        counts = launch_counts()
        got = [out.cpu()]
        pos = torch.tensor([40, 40], device=device)
        step = torch.tensor([[3], [400]], device=device)
        for i in range(2):
            out, cache = model.decode_step(p, cache, step + i, pos + i,
                                           image_feats=f)
            got.append(out.cpu())
        logits[str(device)] = torch.stack(got)
    assert (counts["flash_attention"], counts["flash_attention_sm90"],
            counts["flash_attention_noncausal"]) == (cfg.n_layers, 0, 1)
    assert launch_counts()["flash_attention"] == cfg.n_layers   # decode: 0
    torch.testing.assert_close(logits[str(cuda)], logits["cpu"], rtol=1e-5,
                               atol=1e-5)


# -- the simple flash kernel at head dim 256 (recurrentgemma's MQA) ----------
# Four threads a query row and 16-key tiles; the same tolerances.

@pytest.mark.parametrize("S", [1, 7, 63, 64, 65, 1000, 1024])
@pytest.mark.parametrize("H,K", [(10, 1), (4, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_at_dh_256_matches_plain(cuda, S, H, K, dtype):
    """The routed kernel: the Hopper one of the type (``flash_sm90.cu``
    in bfloat16, ``flash_sm90_f32.cu`` in float32)."""
    from repro_torch.kernels import attention as fa

    B = 2 if S < 512 else 1
    bf16 = dtype == torch.bfloat16
    q, k, v = _qkv(B, S, H, K, 256, dtype, S + H, cuda)
    assert fa.flash_kernel_for(q, k, v) == ("sm90" if bf16 else "sm90_f32")
    reset_launch_counts()
    got = fa.flash_attention(q, k, v)
    counts = launch_counts()
    assert (counts["flash_attention"], counts["flash_attention_sm90"],
            counts["flash_attention_sm90_f32"]) == (1, int(bf16),
                                                    int(not bf16))
    assert got.shape == (B, S, H, 256) and got.dtype == dtype
    _flash_close(got, fa.flash_attention_ref(q, k, v), dtype)


@pytest.mark.parametrize("dh", [129, 200, 255])
@pytest.mark.parametrize("T", [1, 129])
def test_flash_kernel_between_dh_128_and_256_and_noncausal(cuda, dh, T):
    """Head dims padded to 256 (zeros past dh), causal and with a key
    length of its own."""
    from repro_torch.kernels import attention as fa

    q, k, v = _qkv(2, 33, 10, 1, dh, torch.float32, dh + T, cuda)
    _flash_close(fa.flash_attention(q, k, v),
                 fa.flash_attention_ref(q, k, v), torch.float32)
    q, k, v = _cross_qkv(2, 33, T, 10, 1, dh, torch.bfloat16, dh, cuda)
    _flash_close(fa.flash_attention(q, k, v, causal=False),
                 fa.flash_attention_ref(q, k, v, causal=False),
                 torch.bfloat16)


def test_flash_kernel_at_dh_256_reads_strided_views(cuda):
    """q and k / v as views of one fused projection, as ``gqa`` slices
    them (no copy)."""
    from repro_torch.kernels import attention as fa

    B, S, H, K, dh = 2, 77, 10, 1, 256
    gen = torch.Generator().manual_seed(12)
    qkv = torch.randn(B, S, (H + 2 * K) * dh, generator=gen).to(cuda)
    q = qkv[..., :H * dh].view(B, S, H, dh)
    k = qkv[..., H * dh:(H + K) * dh].view(B, S, K, dh)
    v = qkv[..., (H + K) * dh:].view(B, S, K, dh)
    _flash_close(fa.flash_attention(q, k, v), fa.flash_attention_ref(q, k, v),
                 torch.float32)


# -- the Hopper kernel at MLA's q·k 192 / v 128 and at head dim 256 --------
# bfloat16 on TMA's grid goes to csrc/flash_sm90.cu at both pairs; held
# to the plain version and to the simple kernel, the same tolerance.

def _pair_qkv(B, S, T, H, K, dqk, dv, seed, device):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(*shape, generator=gen).to(device, torch.bfloat16)
            for shape in ((B, S, H, dqk), (B, T, K, dqk), (B, T, K, dv))]


PAIRS = [(192, 128, 8, 8), (192, 128, 128, 128), (256, 256, 10, 1),
         (256, 256, 4, 2)]


@pytest.mark.parametrize("S", [7, 1000, 1024])
@pytest.mark.parametrize("dqk,dv,H,K", PAIRS)
def test_flash_sm90_at_mla_and_dh_256_matches_plain_and_simple(
        cuda, S, dqk, dv, H, K):
    from repro_torch.kernels import attention as fa

    B = 2 if S < 512 else 1
    q, k, v = _pair_qkv(B, S, S, H, K, dqk, dv, S + dqk + H, cuda)
    assert fa.flash_kernel_for(q, k, v) == "sm90"
    reset_launch_counts()
    got = fa.flash_attention(q, k, v)
    simple = fa.flash_attention_cuda(q, k, v, kernel="simple")
    counts = launch_counts()
    assert (counts["flash_attention"], counts["flash_attention_sm90"]) \
        == (2, 1)
    assert got.shape == (B, S, H, dv) and got.dtype == torch.bfloat16
    _flash_close(got, fa.flash_attention_ref(q, k, v), torch.bfloat16)
    _flash_close(got, simple, torch.bfloat16)


@pytest.mark.parametrize("T", [1, 129])
@pytest.mark.parametrize("dqk,dv,H,K", PAIRS)
def test_noncausal_flash_sm90_at_mla_and_dh_256_ragged_keys(
        cuda, T, dqk, dv, H, K):
    """A ragged key length: the last key tile is zero-filled past T, and
    only its mask keeps those keys out (a zero key scores 0)."""
    from repro_torch.kernels import attention as fa

    q, k, v = _pair_qkv(2, 65, T, H, K, dqk, dv, T + dqk, cuda)
    reset_launch_counts()
    got = fa.flash_attention(q, k, v, causal=False)
    simple = fa.flash_attention_cuda(q, k, v, kernel="simple", causal=False)
    counts = launch_counts()
    assert (counts["flash_attention"], counts["flash_attention_sm90"],
            counts["flash_attention_noncausal"]) == (2, 1, 2)
    want = fa.flash_attention_ref(q, k, v, causal=False)
    _flash_close(got, want, torch.bfloat16)
    _flash_close(simple, want, torch.bfloat16)


def test_flash_sm90_at_mla_reads_cat_and_expand_views(cuda):
    """bfloat16 views as ``mla`` and its neighbours make them: q a slice
    of a wider projection on the 16-byte grid, k the cat of per-head keys
    and the shared rope key broadcast, v a view of a fused k / v row --
    the Hopper kernel; k as an ``expand`` of one head (stride 0) and q 8
    bytes off the grid -- the simple kernel; every one held to the plain
    version."""
    from repro_torch.kernels import attention as fa

    B, S, H = 2, 77, 4
    gen = torch.Generator().manual_seed(23)
    q_wide = torch.randn(B, S, H, 208, generator=gen).to(cuda,
                                                         torch.bfloat16)
    kv = torch.randn(B, S, H, 128 + 128, generator=gen).to(cuda,
                                                          torch.bfloat16)
    kr = torch.randn(B, S, 64, generator=gen).to(cuda, torch.bfloat16)
    k = torch.cat([kv[..., :128], kr[:, :, None].expand(B, S, H, 64)], -1)
    v = kv[..., 128:]
    for qq, kk, route in ((q_wide[..., 8:200], k, "sm90"),
                          (q_wide[..., 8:200], k[:, :, :1].expand(
                              B, S, H, 192), "simple"),
                          (q_wide[..., 4:196], k, "simple")):
        assert not qq.is_contiguous() and not v.is_contiguous()
        assert fa.flash_kernel_for(qq, kk, v) == route
        reset_launch_counts()
        got = fa.flash_attention(qq, kk, v)
        assert launch_counts()["flash_attention_sm90"] == int(
            route == "sm90")
        _flash_close(got, fa.flash_attention_ref(qq, kk, v), torch.bfloat16)


def test_flash_sm90_at_dh_256_reads_fused_projection_views(cuda):
    """q and k / v as views of one fused bfloat16 projection at head dim
    256, as ``gqa`` slices them: TMA reads them through their strides."""
    from repro_torch.kernels import attention as fa

    B, S, H, K, dh = 2, 77, 10, 1, 256
    gen = torch.Generator().manual_seed(13)
    qkv = torch.randn(B, S, (H + 2 * K) * dh, generator=gen).to(
        cuda, torch.bfloat16)
    q = qkv[..., :H * dh].view(B, S, H, dh)
    k = qkv[..., H * dh:(H + K) * dh].view(B, S, K, dh)
    v = qkv[..., (H + K) * dh:].view(B, S, K, dh)
    assert not q.is_contiguous() and fa.flash_kernel_for(q, k, v) == "sm90"
    reset_launch_counts()
    got = fa.flash_attention(q, k, v)
    assert launch_counts()["flash_attention_sm90"] == 1
    _flash_close(got, fa.flash_attention_ref(q, k, v), torch.bfloat16)


@pytest.mark.parametrize("dqk,dv", [(192, 128), (256, 256)])
def test_flash_sm90_at_mla_and_dh_256_is_causal(cuda, dqk, dv):
    """Changing keys and values from position t on leaves every row
    before t bitwise unchanged (t inside a 64-row block)."""
    from repro_torch.kernels import attention as fa

    B, S, t = 2, 300, 137
    q, k, v = _pair_qkv(B, S, S, 4, 2, dqk, dv, 5, cuda)
    k2, v2 = k.clone(), v.clone()
    k2[:, t:] = 8 * torch.randn_like(k2[:, t:].float()).bfloat16()
    v2[:, t:] = -v2[:, t:] + 3
    reset_launch_counts()
    out, out2 = fa.flash_attention(q, k, v), fa.flash_attention(q, k2, v2)
    assert launch_counts()["flash_attention_sm90"] == 2
    assert torch.equal(out[:, :t], out2[:, :t])
    assert not torch.equal(out[:, t:], out2[:, t:])


# -- the float32 Hopper kernel (csrc/flash_sm90_f32.cu, TF32 mma.sync) ------
# float32 on TMA's grid at (64, 64), (128, 128), (192, 128) and (256, 256)
# goes to it; held to the plain version at float32's 2e-3 and to the
# simple kernel (FFMA, exact float32 products) at the same tolerance.

F32_PAIRS = [(64, 64, 32, 4), (128, 128, 12, 2), (192, 128, 8, 8),
             (256, 256, 10, 1)]


def _f32_qkv(B, S, T, H, K, dqk, dv, seed, device):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(*shape, generator=gen).to(device)
            for shape in ((B, S, H, dqk), (B, T, K, dqk), (B, T, K, dv))]


@pytest.mark.parametrize("causal,S,T", [
    (True, 7, 7), (True, 65, 65), (True, 1000, 1000), (True, 1024, 1024),
    (False, 7, 1600), (False, 65, 129), (False, 256, 1), (False, 64, 1000),
])
@pytest.mark.parametrize("dqk,dv,H,K", F32_PAIRS)
def test_flash_sm90_f32_matches_plain_and_simple(cuda, causal, S, T, dqk,
                                                 dv, H, K):
    """Each head-dim pair, causal and not; ragged S (7, 65, 1000: a
    partial query block) and T (129, 1: one key into the last key tile,
    whose zero-filled keys only the mask keeps out)."""
    from repro_torch.kernels import attention as fa

    B = 2 if S < 512 else 1
    q, k, v = _f32_qkv(B, S, T, H, K, dqk, dv, S + T + dqk, cuda)
    assert fa.flash_kernel_for(q, k, v) == "sm90_f32"
    reset_launch_counts()
    got = fa.flash_attention(q, k, v, causal=causal)
    simple = fa.flash_attention_cuda(q, k, v, kernel="simple", causal=causal)
    counts = launch_counts()
    assert (counts["flash_attention"], counts["flash_attention_sm90"],
            counts["flash_attention_sm90_f32"],
            counts["flash_attention_noncausal"]) \
        == (2, 0, 1, 0 if causal else 2)
    assert got.shape == (B, S, H, dv) and got.dtype == torch.float32
    want = fa.flash_attention_ref(q, k, v, causal=causal)
    _flash_close(got, want, torch.float32)
    _flash_close(got, simple, torch.float32)


@pytest.mark.parametrize("dqk,dv", [(64, 64), (128, 128), (192, 128),
                                    (256, 256)])
def test_flash_sm90_f32_is_causal(cuda, dqk, dv):
    """Changing keys and values from position t on leaves every row
    before t bitwise unchanged (t inside a 64-row block and a key tile),
    and the rows from t on changed."""
    from repro_torch.kernels import attention as fa

    B, S, t = 2, 300, 137
    q, k, v = _f32_qkv(B, S, S, 4, 2, dqk, dv, 5, cuda)
    k2, v2 = k.clone(), v.clone()
    k2[:, t:] = 8 * torch.randn_like(k2[:, t:])
    v2[:, t:] = -v2[:, t:] + 3
    reset_launch_counts()
    out, out2 = fa.flash_attention(q, k, v), fa.flash_attention(q, k2, v2)
    assert launch_counts()["flash_attention_sm90_f32"] == 2
    assert torch.equal(out[:, :t], out2[:, :t])
    assert not torch.equal(out[:, t:], out2[:, t:])


@pytest.mark.parametrize("dh", [64, 256])
def test_noncausal_flash_sm90_f32_reads_every_key(cuda, dh):
    """Changing the last key and value (in the ragged last tile) changes
    the first query's row: no causal mask is left on."""
    from repro_torch.kernels import attention as fa

    q, k, v = _f32_qkv(1, 130, 1000, 4, 2, dh, dh, 3, cuda)
    k2, v2 = k.clone(), v.clone()
    k2[:, -1] = 4 * q[:, 0, :2]
    v2[:, -1] = 8
    reset_launch_counts()
    out = fa.flash_attention(q, k, v, causal=False)
    out2 = fa.flash_attention(q, k2, v2, causal=False)
    assert launch_counts()["flash_attention_sm90_f32"] == 2
    assert not torch.equal(out[:, 0], out2[:, 0])
    _flash_close(out2, fa.flash_attention_ref(q, k2, v2, causal=False),
                 torch.float32)


def test_flash_sm90_f32_reads_mla_and_fused_projection_views(cuda):
    """float32 views as ``mla`` makes them (q a slice of a wider
    projection 16 bytes in, k the cat of per-head keys and the shared
    rope key broadcast, v a view of a fused k / v row) and as ``gqa``
    slices one fused projection at dh 64 and 256 -- the float32 Hopper
    kernel; k as an ``expand`` of one head (stride 0) and q 8 bytes off
    the grid -- the simple kernel; every one held to the plain version."""
    from repro_torch.kernels import attention as fa

    B, S, H = 2, 77, 4
    gen = torch.Generator().manual_seed(29)
    q_wide = torch.randn(B, S, H, 200, generator=gen).to(cuda)
    kv = torch.randn(B, S, H, 128 + 128, generator=gen).to(cuda)
    kr = torch.randn(B, S, 64, generator=gen).to(cuda)
    k = torch.cat([kv[..., :128], kr[:, :, None].expand(B, S, H, 64)], -1)
    v = kv[..., 128:]
    cases = [(q_wide[..., 4:196], k, v, "sm90_f32"),
             (q_wide[..., 4:196], k[:, :, :1].expand(B, S, H, 192), v,
              "simple"),
             (q_wide[..., 2:194], k, v, "simple")]
    for dh, Hq, Kv in ((64, 8, 2), (256, 10, 1)):
        qkv = torch.randn(B, S, (Hq + 2 * Kv) * dh + 4, generator=gen).to(
            cuda)[..., 4:]
        cases.append((qkv[..., :Hq * dh].view(B, S, Hq, dh),
                      qkv[..., Hq * dh:(Hq + Kv) * dh].view(B, S, Kv, dh),
                      qkv[..., (Hq + Kv) * dh:].view(B, S, Kv, dh),
                      "sm90_f32"))
    for qq, kk, vv, route in cases:
        assert not qq.is_contiguous() and not vv.is_contiguous()
        assert fa.flash_kernel_for(qq, kk, vv) == route
        reset_launch_counts()
        got = fa.flash_attention(qq, kk, vv)
        assert launch_counts()["flash_attention_sm90_f32"] == int(
            route == "sm90_f32")
        _flash_close(got, fa.flash_attention_ref(qq, kk, vv), torch.float32)


def test_flash_sm90_f32_forced_and_refused(cuda):
    """``kernel="sm90_f32"`` launches it on inputs it takes and refuses
    bfloat16 and off-grid float32 before any launch; ``kernel="simple"``
    still reaches the simple kernel at its head dims."""
    from repro_torch.kernels import attention as fa

    q, k, v = _f32_qkv(1, 70, 70, 4, 2, 64, 64, 3, cuda)
    reset_launch_counts()
    for qq, kk, vv in ((q.bfloat16(), k.bfloat16(), v.bfloat16()),
                       (q, k[:, :, :1].expand(1, 70, 2, 64), v)):
        with pytest.raises(ValueError, match="sm90_f32 kernel does not"):
            fa.flash_attention_cuda(qq, kk, vv, kernel="sm90_f32")
    assert launch_counts()["flash_attention"] == 0
    got = fa.flash_attention_cuda(q, k, v, kernel="sm90_f32")
    simple = fa.flash_attention_cuda(q, k, v, kernel="simple")
    assert (launch_counts()["flash_attention"],
            launch_counts()["flash_attention_sm90_f32"]) == (2, 1)
    _flash_close(got, simple, torch.float32)


# -- the padded Hopper route (head dims below a tile) ------------------------
# Every equal head dim whose row is a multiple of 16 bytes runs on the
# Hopper kernel of its type in the smallest tile that holds it, TMA's
# zero columns past it; held to the plain version with the tolerance of
# the type, causal and without causality one key into the last key tile.

PAD_DIMS = ([(torch.bfloat16, d) for d in (8, 16, 24, 32, 40, 48, 56, 72, 80,
                                           96, 104, 120, 136, 160, 184, 192,
                                           200, 248)]
            + [(torch.float32, d) for d in (4, 8, 12, 16, 20, 28, 32, 36, 48,
                                            60, 68, 80, 96, 100, 124, 132,
                                            160, 192, 220, 252)])


@pytest.mark.parametrize("causal,S,T", [(True, 130, 130), (False, 65, 129),
                                        (False, 33, 1)])
@pytest.mark.parametrize("dtype,dh", PAD_DIMS,
                         ids=[f"{str(t).split('.')[-1]}-dh{d}"
                              for t, d in PAD_DIMS])
def test_padded_hopper_route_matches_plain(cuda, causal, S, T, dtype, dh):
    from repro_torch.kernels import attention as fa

    q, k, v = (t.to(dtype) for t in _f32_qkv(
        2, S, T, 8, 2, dh, dh, S + T + dh, cuda))
    hopper = "sm90" if dtype == torch.bfloat16 else "sm90_f32"
    assert fa.flash_kernel_for(q, k, v) == hopper
    reset_launch_counts()
    got = fa.flash_attention(q, k, v, causal=causal)
    counts = launch_counts()
    assert (counts["flash_attention"], counts["flash_attention_sm90"],
            counts["flash_attention_sm90_f32"]) == (
        1, int(hopper == "sm90"), int(hopper == "sm90_f32"))
    assert got.shape == (2, S, 8, dh) and got.dtype == dtype
    _flash_close(got, fa.flash_attention_ref(q, k, v, causal=causal), dtype)


@pytest.mark.parametrize("dtype,dh", [(torch.bfloat16, 80),
                                      (torch.bfloat16, 16),
                                      (torch.float32, 36),
                                      (torch.float32, 96)])
def test_padded_hopper_route_reads_views_and_is_causal(cuda, dtype, dh):
    """q, k, v as views of one fused projection 16 bytes in (no copy), on
    the padded route; changing keys and values from position t on leaves
    every earlier row bitwise unchanged."""
    from repro_torch.kernels import attention as fa

    B, S, H, K, t = 2, 150, 4, 2, 77
    gen = torch.Generator().manual_seed(dh)
    pad = 16 // (2 if dtype == torch.bfloat16 else 4)
    qkv = torch.randn(B, S, (H + 2 * K) * dh + pad, generator=gen).to(
        cuda, dtype)[..., pad:]
    q = qkv[..., :H * dh].view(B, S, H, dh)
    k = qkv[..., H * dh:(H + K) * dh].view(B, S, K, dh)
    v = qkv[..., (H + K) * dh:].view(B, S, K, dh)
    hopper = "sm90" if dtype == torch.bfloat16 else "sm90_f32"
    assert not q.is_contiguous() and fa.flash_kernel_for(q, k, v) == hopper
    out = fa.flash_attention(q, k, v)
    _flash_close(out, fa.flash_attention_ref(q, k, v), dtype)
    k2, v2 = k.clone(), v.clone()
    k2[:, t:] = 8 * torch.randn_like(k2[:, t:].float()).to(dtype)
    v2[:, t:] = -v2[:, t:] + 3
    out2 = fa.flash_attention(q, k2, v2)
    assert torch.equal(out[:, :t], out2[:, :t])
    assert not torch.equal(out[:, t:], out2[:, t:])


def test_views_tma_cannot_describe_stay_on_the_simple_kernel(cuda):
    """Off-grid head-dim rows (bfloat16 dh 100, float32 dh 30), a head
    dim that is not contiguous, an expanded kv head: the simple kernel,
    held to the plain version."""
    from repro_torch.kernels import attention as fa

    cases = [_qkv(2, 70, 4, 2, 100, torch.bfloat16, 1, cuda),
             _qkv(2, 70, 4, 2, 30, torch.float32, 2, cuda)]
    q, k, v = _qkv(2, 70, 4, 2, 80, torch.bfloat16, 3, cuda)
    cases.append((q.transpose(-1, -2).contiguous().transpose(-1, -2), k, v))
    q, k, v = _qkv(2, 70, 4, 1, 16, torch.float32, 4, cuda)
    cases.append((q, k.expand(2, 70, 4, 16), v.expand(2, 70, 4, 16)))
    for q, k, v in cases:
        assert fa.flash_kernel_for(q, k, v) == "simple"
        reset_launch_counts()
        got = fa.flash_attention(q, k, v)
        counts = launch_counts()
        assert (counts["flash_attention"], counts["flash_attention_sm90"],
                counts["flash_attention_sm90_f32"]) == (1, 0, 0)
        _flash_close(got, fa.flash_attention_ref(q, k, v), q.dtype)


def test_hybrid_smoke_on_the_card_matches_the_cpu(cuda, monkeypatch,
                                                   exact_flash):
    """recurrentgemma-smoke (float32): a prefill of 12 tokens on the
    window's 16 slots (the local layer on the simple kernel), then decode
    through the ring's wrap to position 20, on the card within 1e-5 of
    the CPU run (TF32 off); the RG-LRU state float32 and equal."""
    from repro_torch import configs
    from repro_torch.models.model import build_model

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = configs.reduced("recurrentgemma-2b")
    params = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (2, 21),
                         generator=torch.Generator().manual_seed(1))
    logits, states = {}, {}
    for device in ("cpu", cuda):
        model = build_model(cfg, device=device)
        p = _to(params, device)
        cache = model.make_cache(2, cfg.window)
        reset_launch_counts()
        out, cache = model.prefill(p, {"tokens": toks[:, :12].to(device)},
                                   cache)
        counts = launch_counts()
        got = [out.cpu()]
        for t in range(12, 21):
            out, cache = model.decode_step(
                p, cache, toks[:, t:t + 1].to(device),
                torch.full((2,), t, device=device))
            got.append(out.cpu())
        logits[str(device)] = torch.stack(got)
        states[str(device)] = cache[1]["b0_rglru"]["h"].cpu()
    assert (counts["flash_attention"], counts["flash_attention_sm90"]) \
        == (1, 0)
    assert launch_counts()["flash_attention"] == 1      # decode: 0
    torch.testing.assert_close(logits[str(cuda)], logits["cpu"], rtol=1e-5,
                               atol=1e-5)
    assert states[str(cuda)].dtype == torch.float32
    torch.testing.assert_close(states[str(cuda)], states["cpu"], rtol=1e-5,
                               atol=1e-5)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


# -- the message layer: vectored puts, the reliable put, mailboxes ----------

def _card_and_cpu_states(cuda, run):
    """``run(device) -> (ctx, state)`` on the CPU and on the card; the
    two states' fields bit for bit, and the same exchanges."""
    import dataclasses as dc

    (ctx_c, st_c), (ctx_g, st_g) = run("cpu"), run(cuda)
    for f in dc.fields(st_c):
        a, b = getattr(st_g, f.name).cpu(), getattr(st_c, f.name)
        assert _same_bits(a, b), f.name
    assert ctx_g.exchanges == ctx_c.exchanges
    return ctx_g, st_g


def _message_cases():
    from test_torch_actors import CASES as ACTOR_CASES
    from test_torch_lossy import PUTS
    from test_torch_vectored import CASES as VECTORED_CASES

    return ([("vectored", n) for n in VECTORED_CASES]
            + [("actors", n) for n in ACTOR_CASES]
            + [("lossy", n) for n in PUTS])


@pytest.mark.parametrize("family,name", _message_cases())
def test_message_layer_cases_on_the_card_match_the_cpu(cuda, family, name):
    """Every vectored, actor and reliable-put program of
    tests/test_torch_{vectored,actors,lossy}.py (held there to the JAX
    package on the CPU; the reliable put here with the port's own hash
    draws, which give the same bits on both devices) on a CUDA context:
    the state bit for bit as the port's CPU run, the same exchanges."""
    import test_torch_actors as ta
    import test_torch_lossy as tl
    import test_torch_vectored as tv
    from repro_torch import runtime
    from repro_torch.core.address_space import GlobalAddressSpace
    from repro_torch.core.state import ShoalContext, replace

    def run(device):
        if family == "lossy":
            case = tl.PUTS[name]
            ctx = ShoalContext(8, tl._lossy(runtime, tl._port_model(
                case, "hash"), case), tl.SEG, device=device)
            from repro_torch.core import handlers as hd, ops
            st = ops.put_long(ctx, ctx.make_state(), torch.from_numpy(
                tl._pay(case)).to(device), list(case.pattern), dst_addr=10,
                token=1, handler=getattr(hd, case.handler),
                dedup=case.dedup, asynchronous=not case.acked)
            return ctx, ops.wait_replies(ctx, st, 1, 1, timeout=True)
        mod = tv if family == "vectored" else ta
        case = mod.CASES[name]
        transport = (tv._transport(runtime, case) if family == "vectored"
                     else runtime.TCP if case.acked else runtime.UDP)
        ctx = ShoalContext(8, transport, case.segment_words, device=device)
        seg0, pay = mod._inputs(name)
        st = GlobalAddressSpace(ctx).make_global_state(seg0.reshape(-1))
        dt = getattr(torch, getattr(case, "dtype", "float32"))
        st = replace(st, segment=st.segment.to(dt))
        p = torch.from_numpy(pay).to(device=device, dtype=dt)
        if family == "vectored":
            from repro_torch.core import handlers as hd, ops
            return ctx, case.prog(ops, hd, ctx, st, p)
        return ctx, case.prog(ta._port_lib(), ctx, st, p)

    _card_and_cpu_states(cuda, run)


def _phase_programs():
    import chip_smoke as cs

    rng = np.random.default_rng(17)
    vec = rng.standard_normal((cs.K, cs.VEC_BLOCKS * cs.VEC_WORDS)).astype(
        np.float32)
    rel = rng.standard_normal((cs.K, cs.REL_SEGS * cs.MTU_WORDS)).astype(
        np.float32)
    bench = ((np.arange(16, dtype=np.float32) + 1)[None]
             * (np.arange(cs.K, dtype=np.float32) + 1)[:, None])
    progs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for asynchronous in (False, True):
            progs[f"vectored-{dtype}-{asynchronous}"] = cs._vectored_prog(
                torch, vec, dtype, asynchronous)
    for name, faults in cs.REL_FAULTS.items():
        progs[f"reliable-{name}"] = cs._reliable_prog(
            torch, rel, faults, cs.MTU_WORDS, cs.MSG_SEG_WORDS, seed=7)
    for pct, drop in (("0", 1e-12), ("1", 0.01), ("5", 0.05)):
        progs[f"bench_faults-{pct}"] = cs._reliable_prog(
            torch, bench, dict(drop=drop), 4, 64, seed=7)
    progs.update({k: p for k, (p, _) in cs._mailbox_progs(
        torch, rng.standard_normal((cs.K, 4096)).astype(np.float32)).items()})
    return progs


PHASE_PROGRAMS = ["vectored-torch.float32-False", "vectored-torch.float32-True",
                  "vectored-torch.bfloat16-False",
                  "vectored-torch.bfloat16-True", "reliable-drop-0pct",
                  "reliable-drop-1pct", "reliable-drop-5pct",
                  "reliable-dup-5pct", "reliable-corrupt-2pct",
                  "bench_faults-0", "bench_faults-1", "bench_faults-5",
                  "mailbox-1024x4", "multi-mailbox-2x64",
                  "reply-mailbox-4puts"]


@pytest.mark.parametrize("name", PHASE_PROGRAMS)
def test_message_phase_programs_on_the_card_match_the_cpu(cuda, name):
    """chip_smoke.py's message-phase programs at their full size (34 x
    64-word vectored puts, 16 x 2250-word reliable puts over a lossy
    ring, 1024 mailbox sends) on the card: bit for bit the CPU run."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    prog = _phase_programs()[name]
    _card_and_cpu_states(cuda, lambda d: prog(torch.device(d)))


def _message_shapes():
    """(op, K, B, W, layout) of the DataMover at the message layer's
    shapes: scripts/datamover_sweep.py's points at W 4 and 8, ragged
    rows, gated duplicate rows and the message layer's own shapes."""
    out = []
    for K in (1, 8):
        for B in (1, 3, 40, 1024):
            for W in (4, 8, 64):
                out.append(("gather", K, B, W, "ragged"))
                for layout in ("disjoint", "ragged", "gated-dup"):
                    out.append(("scatter", K, B, W, layout))
    return out + [("gather", 8, 1, 2176, "disjoint"),
                  ("gather", 8, 16, 2250, "ragged"),
                  ("scatter", 8, 32, 2250, "gated-dup"),
                  ("scatter", 8, 34, 64, "ragged")]


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32,
                                   torch.bfloat16])
@pytest.mark.parametrize("op,K,B,W,layout", _message_shapes())
def test_datamover_message_shapes_match_plain_on_both_designs(
        cuda, dtype, op, K, B, W, layout):
    """Both designs and the routed kernel at the new shapes, bitwise
    against the plain version on the same inputs."""
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts"))
    import datamover_sweep as sweep

    gen = torch.Generator(device=cuda).manual_seed(B * 7 + W)
    seg, pay, addr, nwords, hid, active = sweep.case(
        torch, op, K, B, W, layout, None, dtype, gen, cuda)
    for kernel in _designs(dtype):
        if op == "gather":
            got = dm.datamover_gather_cuda(seg, addr, nwords, W,
                                           kernel=kernel)
            want = dm.datamover_gather_ref(seg, addr, nwords, W)
        else:
            got = dm.datamover_scatter_cuda(seg.clone(), pay, addr, nwords,
                                            hid, active, kernel=kernel)
            want = dm.datamover_scatter_ref(seg.clone(), pay, addr, nwords,
                                            hid, active)
        assert _same_bits(got, want), kernel


# -- the disaggregated serving tier ------------------------------------------

def test_disagg_tier_on_the_card_matches_the_cpu(cuda, exact_flash):
    """tinyllama-smoke (float32) through the disaggregated tier (2 + 2
    kernels, 2 lanes each) on the card gives the CPU run's tokens, 6
    migrations at 2 exchanges each, no error bit, every landed lane
    bitwise the prefill worker's; every prompt pass takes the flash
    kernel."""
    from repro_torch import configs
    from repro_torch.launch.mesh import ServingSlices
    from repro_torch.models.model import build_model
    from repro_torch.serving import DisaggServeTier, Request
    from serving_checks import MAX_NEW, PROMPTS

    cfg = configs.reduced("tinyllama-1.1b")
    params = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    outs, landed = {}, []
    for device in ("cpu", cuda):
        model = build_model(cfg, device=device)
        tier = DisaggServeTier(model, _to(params, device),
                               ServingSlices(2, 2), lanes_per_decode=2,
                               slots=16, device=device)
        migrate = tier.migrate

        def checked(src, dst, lane, lane_cache, migrate=migrate):
            adopted = migrate(src, dst, lane, lane_cache)
            landed.append(all(
                torch.equal(a[key][n], w[key][n])
                for a, w in zip(adopted, lane_cache) for key in w
                for n in w[key]))
            return adopted

        tier.migrate = checked
        reset_launch_counts()
        done = tier.run([Request(i, np.asarray(p, np.int32), m)
                         for i, (p, m) in enumerate(zip(PROMPTS, MAX_NEW))])
        outs[str(device)] = {r.rid: r.out for r in done}
        assert tier.migrations == len(PROMPTS)
        assert tier.ctx.exchanges == 2 * len(PROMPTS)
        assert int(tier.state.error.abs().sum()) == 0
    assert outs["cpu"] == outs[str(cuda)]
    assert landed == [True] * (2 * len(PROMPTS))
    assert launch_counts()["flash_attention"] == len(PROMPTS) * cfg.n_layers


@pytest.mark.parametrize("pattern,lane", [([(0, 2)], 1), ([(1, 3)], 0),
                                          ([(0, 0)], 1)])
def test_kv_migration_on_the_card_matches_the_cpu(cuda, pattern, lane):
    """One migration of a seeded lane cache (smoke size): every state
    field bitwise the CPU run's, at the same exchanges."""
    from repro_torch import configs
    from repro_torch.core.address_space import GlobalAddressSpace
    from repro_torch.core.state import ShoalContext
    from repro_torch.models.convert import cache_from_numpy
    from repro_torch.models.model import build_model
    from repro_torch.serving import KvSegmentSpace
    from test_torch_serving_disagg import _lane_tree

    cfg = configs.reduced("tinyllama-1.1b")
    seg0 = np.random.default_rng(lane).standard_normal(
        (4, 2 * 2080)).astype(np.float32)

    def run(device):
        model = build_model(cfg, device=device)
        ctx = ShoalContext(4, segment_words=seg0.shape[1], device=device)
        gas = GlobalAddressSpace(ctx)
        kv = KvSegmentSpace(gas, model, lanes=2, slots=16)
        lane_cache = cache_from_numpy(cfg, _lane_tree(cfg, 3), device=device)
        st = kv.migrate(gas.make_global_state(seg0.reshape(-1)),
                        kv.pack_lane(lane_cache), pattern, lane)
        return ctx, st

    ctx, _ = _card_and_cpu_states(cuda, run)
    assert ctx.exchanges == (0 if pattern == [(0, 0)] else 2)


def _migration_shape(cuda):
    """tinyllama-1.1b's full lane layout (22 layers of k, pos and v at
    2048 slots) on 4 kernels of 2 lanes: the KV space, seeded words and
    the three DataMover calls of one migration."""
    from repro_torch import configs
    from repro_torch.core import am
    from repro_torch.core.address_space import GlobalAddressSpace
    from repro_torch.core.state import ShoalContext
    from repro_torch.models.model import build_model
    from repro_torch.runtime import TCP
    from repro_torch.serving import KvSegmentSpace
    from repro_torch.serving.disagg import _lane_words

    model = build_model(configs.full("tinyllama-1.1b"), device=cuda)
    lw = _lane_words(model, 2048)
    transport = dataclasses.replace(
        TCP, max_packet_bytes=4 * (lw + 66 + am.HDR_WORDS))
    ctx = ShoalContext(4, transport, 2 * lw, device=cuda)
    kv = KvSegmentSpace(GlobalAddressSpace(ctx), model, lanes=2, slots=2048)
    sizes = [leaf.words for leaf in kv.leaves for _ in range(leaf.layers)]
    return kv, sizes


@pytest.mark.parametrize("call", ["egress", "blocks", "scatter"])
def test_datamover_at_the_migration_shape_matches_plain(cuda, call):
    """Both DataMover designs at one full-width migration's shapes
    (tinyllama-1.1b: 66 ragged blocks of 524,288 and 2048 words), bitwise
    against the plain version: the packet's egress gather, the ragged
    block gather of ``ingress_vectored`` and the block scatter into the
    decode kernel's segment."""
    kv, sizes = _migration_shape(cuda)
    assert len(sizes) == 66 and sum(sizes) == kv.lane_words == 23113728
    K, B, W = 4, len(sizes), max(sizes)
    gen = torch.Generator(device=cuda).manual_seed(B)
    payload = torch.randn(K, kv.lane_words, generator=gen, device=cuda)
    offs = np.cumsum([0] + sizes[:-1]).tolist()
    addr, nwords = _i32([offs] * K, cuda), _i32([sizes] * K, cuda)
    if call == "egress":
        args = (payload, _i32([[0]] * K, cuda), _i32([[kv.lane_words]] * K,
                                                     cuda), kv.lane_words)
    elif call == "blocks":
        args = (payload, addr, nwords, W)
    if call != "scatter":
        want = dm.datamover_gather_ref(*args)
        for kernel in ("sm90", "simple"):
            assert _same_bits(dm.datamover_gather_cuda(*args, kernel=kernel),
                              want), kernel
        return
    rows = dm.datamover_gather_ref(payload, addr, nwords, W)
    seg = torch.randn(K, kv.ctx.segment_words, generator=gen, device=cuda)
    dst = 2
    block_addr = _i32([kv.block_addrs(1, kernel=dst)] * K, cuda)
    ones = _i32([[1] * B] * K, cuda)
    active = _i32([[int(k == dst)] * B for k in range(K)], cuda)
    want = dm.datamover_scatter_ref(seg.clone(), rows, block_addr, nwords,
                                    ones, active)
    for kernel in ("sm90", "simple"):
        got = dm.datamover_scatter_cuda(seg.clone(), rows, block_addr,
                                        nwords, ones, active, kernel=kernel)
        assert _same_bits(got, want), kernel
    assert dm.datamover_kernel_for("scatter", K, B, W, torch.float32) \
        == "sm90"


# -- the data-parallel trainer ------------------------------------------------

def _moved(tree, device):
    from repro_torch.tree import tree_map

    return tree_map(lambda t: t.to(device), tree)


def _pipe():
    from repro_torch.data import DataConfig, TokenPipeline

    return TokenPipeline(DataConfig(vocab=512, batch=8, seq=32, seed=1),
                         device="cpu")


def _batch(host, device):
    return {k: torch.from_numpy(v).to(device, dtype=torch.int64)
            for k, v in host.items()}


def _train_on(device, backend, comp=False, steps=2, K=4):
    """tinyllama-smoke (float32) trained ``steps`` steps on ``device``
    from the same seeded weights and batches: (trainer, state, losses,
    ring launches per step)."""
    from repro_torch import configs
    from repro_torch.models.model import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.training import Trainer, TrainerConfig

    cfg = configs.reduced("tinyllama-1.1b")
    params = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    trainer = Trainer(build_model(cfg, device=device), AdamWConfig(lr=1e-3),
                      TrainerConfig(comm_backend=backend,
                                    grad_compression=comp), kernels=K)
    st = trainer.state_for(_to(params, device))
    pipe = _pipe()
    losses, launches = [], []
    for s in range(steps):
        reset_launch_counts()
        st, met = trainer.step(st, _batch(pipe.batch_at(s), device))
        losses.append(float(met["loss"]))
        launches.append(launch_counts())
    return trainer, st, losses, launches


@pytest.mark.parametrize("backend", ["xla", "shoal"])
def test_reduced_trainer_on_the_card_matches_the_cpu(cuda, backend,
                                                     monkeypatch):
    """Two steps of the float32 trainer, each from the CPU run's state on
    both devices (TF32 off): the loss within 1e-5, every synced gradient
    leaf within 1e-5 of its largest |gradient|, and the update of the
    same gradients -- every parameter, moment and the count -- within
    1e-5.  (Two chained runs are not compared leaf for leaf: Adam
    divides by sqrt(v), so an element whose gradient is a near-
    cancelling sum, and so differs in its leading digits between the
    devices' summation orders, moves by a visible part of lr.)  The
    shoal step launches the ring kernel once per leaf on
    ``ring_kernel_for``'s route, 2(K - 1) exchanges a leaf; the xla
    step launches none; neither launches flash."""
    from repro_torch.tree import tree_paths

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    cpu_tr, cpu_st, _, _ = _train_on("cpu", backend, steps=0)
    card_tr, _, _, _ = _train_on(cuda, backend, steps=0)
    pipe = _pipe()
    leaves = len(tree_paths(cpu_st.params))
    routes = [gd.ring_kernel_for(4, -(-leaf.numel() // 4), torch.float32,
                                 gd.ALL_REDUCE)
              for _, leaf in tree_paths(cpu_st.params)]
    for step in range(2):
        batch = pipe.batch_at(step)
        loss_c, g_c, _ = cpu_tr.grads(cpu_st, _batch(batch, "cpu"))
        reset_launch_counts()
        loss_g, g_g, _ = card_tr.grads(_moved(cpu_st, cuda),
                                       _batch(batch, cuda))
        counts = launch_counts()
        np.testing.assert_allclose(float(loss_g), float(loss_c), rtol=1e-5,
                                   atol=1e-5)
        for (path, a), (_, b) in zip(tree_paths(g_g), tree_paths(g_c)):
            np.testing.assert_allclose(
                a.cpu().double().numpy(), b.double().numpy(), rtol=0,
                atol=1e-5 * b.abs().max().item(), err_msg=path)
        assert counts["ring_collective"] == (
            leaves if backend == "shoal" else 0)
        assert counts["ring_cluster_sm90"] == (
            routes.count("sm90") if backend == "shoal" else 0)
        assert counts["flash_attention"] == 0
        new_c, _ = cpu_tr.apply_update(cpu_st, g_c, loss_c)
        new_g, _ = card_tr.apply_update(_moved(cpu_st, cuda),
                                        _moved(g_c, cuda), loss_g)
        for (path, a), (_, b) in zip(tree_paths(new_g), tree_paths(new_c)):
            np.testing.assert_allclose(a.cpu().double().numpy(),
                                       b.double().numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=path)
        cpu_st = new_c
    if backend == "shoal":
        assert card_tr.ctx.exchanges == 2 * leaves * 2 * (4 - 1)


def test_trainer_sync_on_the_card_rows_equal_and_int32_exact(cuda,
                                                             monkeypatch):
    """Every all-reduced leaf bitwise the plain ring's on the same input
    (on the CPU) and its K rows bitwise equal; compressed, the int32 ring
    result equals the int64 sum of the payloads exactly and the (K, 1)
    scale goes through the ring too (two launches a leaf)."""
    from repro_torch.core import collectives as coll
    from repro_torch.core.state import ShoalContext

    calls = []
    real = coll.ring_all_reduce

    def spy(ctx, x):
        out = real(ctx, x)
        calls.append((x.clone(), out.clone()))
        return out

    monkeypatch.setattr(coll, "ring_all_reduce", spy)
    for comp in (False, True):
        calls.clear()
        trainer, _, _, launches = _train_on(cuda, "shoal", comp=comp,
                                            steps=1)
        leaves = 12
        assert launches[0]["ring_collective"] == len(calls) \
            == leaves * (2 if comp else 1)
        plain_ctx = ShoalContext(4, device="cpu")
        for x, out in calls:
            assert x.device.type == "cuda"
            assert torch.equal(out.cpu(), real(plain_ctx, x.cpu()))
            assert torch.equal(out, out[:1].expand_as(out))
            if x.dtype == torch.int32:
                assert torch.equal(out[0], x.sum(0, dtype=torch.int64).int())


def test_compressed_sync_on_the_card_matches_the_cpu(cuda, monkeypatch):
    """One compressed shoal sync from the same float32 state on both
    devices (TF32 off): the loss within 1e-5 and every synced leaf within
    one quantization step of the synced sum (the members' mean int8
    scale over K: a payload that rounds the other way on one device)
    plus 1e-5 of its largest value; every member's residual within half
    its own step."""
    from repro_torch.tree import tree_paths

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    cpu_tr, cpu_st, _, _ = _train_on("cpu", "shoal", comp=True, steps=0)
    card_tr, _, _, _ = _train_on(cuda, "shoal", comp=True, steps=0)
    batch = _pipe().batch_at(0)
    members = [dict(tree_paths(g)) for _, g in
               cpu_tr.member_grads(cpu_st.params, _batch(batch, "cpu"))]
    loss_c, g_c, r_c = cpu_tr.grads(cpu_st, _batch(batch, "cpu"))
    loss_g, g_g, r_g = card_tr.grads(_moved(cpu_st, cuda),
                                     _batch(batch, cuda))
    np.testing.assert_allclose(float(loss_g), float(loss_c), rtol=1e-5,
                               atol=1e-5)
    residuals = dict(tree_paths(r_g))
    for (path, a), (_, b) in zip(tree_paths(g_g), tree_paths(g_c)):
        steps = np.array([max(m[path].abs().max().item(), 1e-12) / 127
                          for m in members])
        np.testing.assert_allclose(
            a.cpu().double().numpy(), b.double().numpy(), rtol=0,
            atol=steps.mean() / 4 + 1e-5 * b.abs().max().item(),
            err_msg=path)
        r = residuals[path].cpu().double()
        for k in range(4):
            assert r[k].abs().max().item() <= steps[k] * (0.5 + 1e-4), path


def test_flash_guard_refuses_cuda_inputs_that_require_grad(cuda):
    from repro_torch.kernels.attention import flash_attention

    q = torch.zeros(1, 4, 2, 64, device=cuda, dtype=torch.bfloat16,
                    requires_grad=True)
    kv = torch.zeros(1, 4, 2, 64, device=cuda, dtype=torch.bfloat16)
    reset_launch_counts()
    with pytest.raises(RuntimeError, match="Model.loss"):
        flash_attention(q, kv, kv)
    assert launch_counts()["flash_attention"] == 0


def test_delivery_live_mask_on_the_card_matches_the_cpu(cuda):
    """The exhausting reliable put of tests/test_torch_pipeline_elastic.py
    on a CUDA context (its DataMover on the card): the same error words
    and live mask as on the CPU."""
    from test_torch_pipeline_elastic import _exhausting_put

    from repro_torch.training.elastic import delivery_live_mask

    for lossy_from in (None, 3):
        on_card = _exhausting_put(cuda, lossy_from).error
        on_cpu = _exhausting_put("cpu", lossy_from).error
        assert torch.equal(on_card.cpu(), on_cpu)
        assert torch.equal(delivery_live_mask(torch.ones(8, device=cuda),
                                              on_card).cpu(),
                           delivery_live_mask(torch.ones(8), on_cpu))


def _lint_names():
    from repro_torch.analysis import registry

    return ([("entry", n) for n in registry.names()]
            + [("probe", p.name) for p in registry.PROBES
               if p.raises is None])


@pytest.mark.parametrize("kind,name", _lint_names())
def test_lint_on_the_card_matches_the_cpu(cuda, kind, name):
    """Every lint entry and probe on the card: the CPU run's findings,
    events, exchanges and result, bitwise."""
    from repro_torch.analysis import registry
    from repro_torch.analysis.lint import events_json
    from repro_torch.core.state import state_to_numpy

    def run(device):
        if kind == "entry":
            return registry.lint_entry(name, device=device)
        return registry.run_probe(name, device=device)

    card, host = run(cuda), run("cpu")
    assert [f.render() for f in card.report.findings] \
        == [f.render() for f in host.report.findings]
    assert events_json(card.events) == events_json(host.events)
    assert (card.exchanges, card.tags) == (host.exchanges, host.tags)
    got, want = card.result, host.result
    if name == "moe-dispatch":
        # a float32 model's loss: the card's GEMMs round otherwise
        assert card.collectives == host.collectives
        assert card.report.budget == host.report.budget
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
        return
    if isinstance(got, tuple):
        assert torch.equal(got[1].cpu(), want[1])
        got, want = got[0], want[0]
    a, b = state_to_numpy(got), state_to_numpy(want)
    for f in a:
        assert np.array_equal(a[f].view(np.int32) if a[f].dtype == np.float32
                              else a[f], b[f].view(np.int32)
                              if b[f].dtype == np.float32 else b[f]), f


def _island_case(device, dispatch, dtype):
    from repro_torch.models import moe as tmoe

    dims = tmoe.MoEDims(n_experts=8, top_k=2, d_ff_expert=96,
                        capacity_factor=16.0, dispatch=dispatch)
    gen = torch.Generator().manual_seed(4)
    p = {k: v.to(device) for k, v in tmoe.init_moe(gen, 64, dims,
                                                    dtype=dtype).items()}
    h = torch.randn(2, 64, 64, generator=gen).to(dtype).to(device)
    return dims, p, h


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("dispatch", ["psum", "rs", "a2a"])
def test_moe_island_on_the_card_matches_moe_ffn(cuda, dispatch, dtype, tol):
    """The expert-parallel island over 4 kernels x 2 data groups on the
    card, at a capacity that drops nothing: ``moe_ffn`` on the card
    within ``tol`` of the largest |out|, its CPU run likewise, and the
    dispatch's collective calls and ring launches."""
    from repro_torch.core.state import ShoalContext
    from repro_torch.models import moe as tmoe

    outs = {}
    for device in (cuda, torch.device("cpu")):
        dims, p, h = _island_case(device, dispatch, dtype)
        ctx = ShoalContext(4, device=device)
        reset_launch_counts()
        with torch.no_grad():
            out, _ = tmoe.moe_routed_island(p, h, dims,
                                            tmoe.ExpertMesh(ctx, data=2),
                                            dtype)
            want, _ = tmoe.moe_ffn(p, h, dims)
        top = want.float().abs().max().item()
        assert (out.float() - want.float()).abs().max().item() <= tol * top
        outs[device.type] = out.float().cpu()
        rings = {"psum": 2, "rs": 3, "a2a": 1}[dispatch]
        if device.type == "cuda":
            torch.cuda.synchronize()
            assert launch_counts()["ring_collective"] == rings
        assert sum(ctx.collectives.values()) == {"psum": 2, "rs": 3,
                                                 "a2a": 3}[dispatch]
    top = outs["cpu"].abs().max().item()
    assert (outs["cuda"] - outs["cpu"]).abs().max().item() <= tol * top


def test_moe_island_refuses_grad_on_the_card(cuda, monkeypatch):
    """The island used to refuse inputs that require grad; on the card it
    now differentiates through the ring kernel.  Over 4 kernels x 2 data
    groups (float32, TF32 off), the gradients of ``(out . w).sum() +
    aux`` in ``h`` and the routed leaves within 1e-4 of each leaf's
    largest |grad| of the CPU run's, and the ring launched once for each
    forward and backward ring collective: psum 2 + 4, rs 3 + 4, a2a
    1 + 2 (the all-to-alls are no launch)."""
    from repro_torch.core.state import ShoalContext
    from repro_torch.models import moe as tmoe

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    for dispatch, rings in (("psum", 6), ("rs", 7), ("a2a", 3)):
        grads = {}
        for device in (cuda, torch.device("cpu")):
            dims, p, h = _island_case(device, dispatch, torch.float32)
            w = torch.randn(h.shape, generator=torch.Generator().manual_seed(
                5)).to(device)
            leaves = [p[n].requires_grad_() for n in tmoe.ROUTED]
            h.requires_grad_()
            ctx = ShoalContext(4, device=device)
            reset_launch_counts()
            out, aux = tmoe.moe_routed_island(p, h, dims,
                                              tmoe.ExpertMesh(ctx, data=2),
                                              torch.float32)
            grads[device.type] = [g.cpu() for g in torch.autograd.grad(
                (out * w).sum() + aux, [h] + leaves)]
            if device.type == "cuda":
                torch.cuda.synchronize()
                assert launch_counts()["ring_collective"] == rings, dispatch
        for a, b in zip(grads["cuda"], grads["cpu"]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=1e-4 * b.abs().max().item(),
                                       err_msg=dispatch)


@pytest.mark.parametrize("K", [2, 3, 8])
@pytest.mark.parametrize("op", ["reduce_scatter", "all_gather",
                                "all_reduce", "all_to_all", "broadcast"])
def test_collective_backward_on_the_card_matches_the_cpu(cuda, op, K):
    """Each collective's backward on the card (the adjoint on the ring
    kernel, one launch; the all-to-all's transpose, none) bitwise the
    CPU run's, 35 words a kernel (a ragged split)."""
    from test_torch_collectives import _grad_call

    from repro_torch.core.state import ShoalContext

    rng = np.random.default_rng(K)
    shape = {"all_to_all": (K, 2 * K, 3), "broadcast": (5, 7)}.get(
        op, (K, 5, 7))
    x = rng.standard_normal(shape).astype(np.float32)
    got = {}
    for device in (cuda, torch.device("cpu")):
        xt = torch.tensor(x, device=device, requires_grad=True)
        ctx = ShoalContext(K, device=device)
        reset_launch_counts()
        y = _grad_call(op, ctx, xt)
        g = torch.tensor(np.random.default_rng(K + 1).standard_normal(
            tuple(y.shape)).astype(np.float32), device=device)
        (got[device.type],) = torch.autograd.grad(y, xt, g)
        if device.type == "cuda":
            torch.cuda.synchronize()
            want = {"all_to_all": 0, "broadcast": 1}.get(op, 2)
            assert launch_counts()["ring_collective"] == want
    assert torch.equal(got["cuda"].cpu().view(torch.int32),
                       got["cpu"].view(torch.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
def test_custom_handlers_on_the_card_match_the_cpu(cuda, dtype):
    """A table with custom handlers on a CUDA segment: overlapping
    blocks, inactive ones, lanes past ``nwords`` and the segment's ends,
    ids past the table's end, landed through the DataMover gather and
    scatter one block at a time (one launch of each a block), bitwise
    the plain scatter on the CPU; the built-in table keeps one scatter
    launch a call."""
    from test_torch_guard import _handler_tables

    from repro_torch.core import handlers as hd

    table = _handler_tables(dtype)
    g = torch.Generator().manual_seed(11)
    K, S, B, W = 3, 4096, 40, 96
    if dtype == torch.int32:
        seg = torch.randint(-50, 50, (K, S), generator=g, dtype=dtype)
        pay = torch.randint(-50, 50, (K, B, W), generator=g, dtype=dtype)
    else:
        seg = torch.randn(K, S, generator=g).to(dtype)
        pay = torch.randn(K, B, W, generator=g).to(dtype)
    addr = (torch.arange(B, dtype=torch.int32) * 61 - 20).expand(K, B) \
        + torch.arange(K, dtype=torch.int32)[:, None]
    nwords = torch.randint(0, W + 1, (K, B), generator=g, dtype=torch.int32)
    handler = torch.randint(-2, len(table) + 4, (K, B), generator=g,
                            dtype=torch.int32)
    active = (torch.rand(K, B, generator=g) > 0.15).to(torch.int32)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    for tab, scatters, gathers in ((table, B, B), (hd.DEFAULT_TABLE, 1, 0)):
        hid = handler if tab is table else handler.clamp(0, 4)
        want = dm.datamover_scatter(seg.clone(), pay, addr, nwords, hid,
                                    active, tab)
        reset_launch_counts()
        got = dm.datamover_scatter(seg.clone().to(cuda), pay.to(cuda),
                                   addr.to(cuda), nwords.to(cuda),
                                   hid.to(cuda), active.to(cuda), tab)
        torch.cuda.synchronize()
        counts = launch_counts()
        assert torch.equal(got.cpu().view(bits), want.view(bits))
        assert counts["datamover_scatter"] + counts[
            "datamover_scatter_sm90"] == scatters
        assert counts["datamover_gather"] + counts[
            "datamover_gather_sm90"] == gathers


def test_ep_trainer_on_the_card_matches_the_cpu(cuda, monkeypatch):
    """dbrx-smoke with ``Model(..., ep=ExpertMesh(ShoalContext(4),
    data=2))`` (float32, TF32 off): one ``xla`` step's loss within 1e-5
    and every gradient leaf within 1e-5 of its largest |gradient| of the
    CPU run's; the step's ring launches the island's, forward and
    backward, 6 a MoE layer (psum; the loss weighs aux in)."""
    from repro_torch import configs
    from repro_torch.core.state import ShoalContext
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.models import moe as tmoe
    from repro_torch.models.model import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.training import Trainer
    from repro_torch.tree import tree_map, tree_paths

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = configs.reduced("dbrx-132b")
    params = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    batch, _ = TokenPipeline(DataConfig(vocab=cfg.vocab, batch=4, seq=16,
                                        seed=0)).next_batch(0)
    got = {}
    for device in (cuda, torch.device("cpu")):
        model = build_model(cfg, device=device, ep=tmoe.ExpertMesh(
            ShoalContext(4, device=device), data=2))
        reset_launch_counts()
        got[device.type] = Trainer(model, AdamWConfig(lr=1e-3)).value_and_grad(
            tree_map(lambda t: t.to(device), params),
            {k: v.to(device) for k, v in batch.items()})
        if device.type == "cuda":
            torch.cuda.synchronize()
            assert launch_counts()["ring_collective"] == 6 * cfg.n_layers
    (lg, gg), (lc, gc) = got["cuda"], got["cpu"]
    np.testing.assert_allclose(float(lg), float(lc), rtol=1e-5, atol=1e-5)
    for (path, a), (_, b) in zip(tree_paths(gg), tree_paths(gc)):
        np.testing.assert_allclose(a.cpu().double().numpy(),
                                   b.double().numpy(), rtol=0,
                                   atol=1e-5 * b.abs().max().item(),
                                   err_msg=path)


# -- ring attention and the seq_shard route ----------------------------------

def test_ring_attention_on_the_card_matches_the_cpu(cuda, monkeypatch):
    """``ring_attention`` at ``tests/md_checks.py:532``'s shapes (float32,
    4 kernels x 2 data groups, the test file's seeded inputs) on the card
    within 2e-5 of its CPU run (cuBLAS sums the block products in
    another order than the CPU, so not bitwise; TF32 off), at the same
    3 x 4 exchanges, and within 2e-5 of ``_attend`` on the card."""
    from repro_torch.core.state import ShoalContext
    from repro_torch.models.attention import _attend
    from repro_torch.models.moe import ExpertMesh
    from repro_torch.models.ring_attention import ring_attention
    from test_torch_ring_attention import _qkv

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    outs, ex = {}, {}
    for device in ("cpu", cuda):
        q, k, v, pos = (torch.from_numpy(a).to(device) for a in _qkv())
        mesh = ExpertMesh(ShoalContext(4, device=device), data=2)
        outs[str(device)] = ring_attention(mesh, q, k, v, pos)
        ex[str(device)] = mesh.ctx.exchanges
        if device != "cpu":
            torch.testing.assert_close(outs[str(device)],
                                       _attend(q, k, v, pos, pos),
                                       rtol=2e-5, atol=2e-5)
    assert ex["cpu"] == ex[str(cuda)] == 12
    torch.testing.assert_close(outs[str(cuda)].cpu(), outs["cpu"],
                               rtol=2e-5, atol=2e-5)


def test_seq_shard_model_on_the_card_matches_the_cpu(cuda, monkeypatch):
    """qwen2-smoke with ``seq_shard=True, tp=False`` over 4 kernels x 2
    data groups (float32, TF32 off): ``Model.loss`` and every gradient
    leaf within 1e-5 (of the leaf's largest |gradient|) of the CPU run,
    a ring prefill's last logits and its cache within 1e-5, the same
    exchanges (2 layers: the loss's 12 and its backward's 6 a layer,
    the compiled JAX value_and_grad's count, and the prefill's 12)."""
    import dataclasses as dc

    from repro_torch import configs
    from repro_torch.core.state import ShoalContext
    from repro_torch.models.model import build_model
    from repro_torch.models.moe import ExpertMesh
    from repro_torch.optim import AdamWConfig
    from repro_torch.training import Trainer
    from repro_torch.tree import tree_leaves

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = dc.replace(configs.reduced("qwen2-1.5b"), tp=False, seq_shard=True)
    params = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (2, 32),
                         generator=torch.Generator().manual_seed(2))
    res = {}
    for device in ("cpu", cuda):
        mesh = ExpertMesh(ShoalContext(4, device=device), data=2)
        model = build_model(cfg, device=device, ep=mesh)
        p = _to(params, device)
        batch = {"tokens": toks.to(device), "labels": toks.to(device)}
        loss, grads = Trainer(model, AdamWConfig()).value_and_grad(p, batch)
        with torch.no_grad():
            logits, cache = model.prefill(p, {"tokens": toks.to(device)},
                                          model.make_cache(2, 40))
        res[str(device)] = (loss.cpu(), [g.cpu() for g in tree_leaves(grads)],
                            logits.cpu(), [c.cpu() for c in
                                           tree_leaves(cache)],
                            mesh.ctx.exchanges)
    (l_c, g_c, o_c, c_c, e_c), (l_g, g_g, o_g, c_g, e_g) = \
        res["cpu"], res[str(cuda)]
    assert e_c == e_g == 2 * (12 + 6) + 2 * 12
    torch.testing.assert_close(l_g, l_c, rtol=1e-5, atol=1e-5)
    for a, b in zip(g_g, g_c):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-5 * b.abs().max().item())
    torch.testing.assert_close(o_g, o_c, rtol=1e-5, atol=1e-5)
    for a, b in zip(c_g, c_c):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


# -- the MLA, hybrid and xLSTM lanes ------------------------------------------

def _lane_space(cfg, device):
    from repro_torch.core.address_space import GlobalAddressSpace
    from repro_torch.core.state import ShoalContext
    from repro_torch.models.model import build_model
    from repro_torch.runtime import TCP
    from repro_torch.serving import KvSegmentSpace
    from repro_torch.serving.disagg import _lane_words
    from test_torch_serving_disagg import _lane_transport

    model = build_model(cfg, device=device)
    lw = _lane_words(model, 16)
    n_blocks = sum(leaf.shape[0] for seg in model.make_cache(1, 16)
                   for blk in seg.values() for leaf in blk.values())
    transport = _lane_transport(TCP, lw, n_blocks)
    ctx = ShoalContext(4, transport, 2 * lw, device=device)
    gas = GlobalAddressSpace(ctx)
    return model, gas, KvSegmentSpace(gas, model, lanes=2, slots=16), \
        transport


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "recurrentgemma-2b",
                                  "xlstm-350m"])
def test_lane_migration_on_the_card_matches_the_cpu(cuda, arch):
    """One acked migration of a seeded lane of each kind of state (MLA's
    latent cache, the hybrid's ring and RG-LRU state, the xLSTM states;
    smoke size): every state field bitwise the CPU run's, 2 exchanges,
    and the landed lane bitwise the lane on the card."""
    from repro_torch import configs
    from repro_torch.tree import tree_paths
    from test_torch_serving_disagg import _seeded_lane

    cfg = configs.reduced(arch)

    def run(device):
        model, gas, kv, _ = _lane_space(cfg, device)
        lane = _seeded_lane(model, 11)
        lane = _to(lane, device)
        seg0 = np.random.default_rng(5).standard_normal(
            (4, gas.segment_words)).astype(np.float32)
        st = kv.migrate(gas.make_global_state(seg0.reshape(-1)),
                        kv.pack_lane(lane), [(1, 3)], 1)
        if device != "cpu":
            got = dict(tree_paths(kv.unpack_lane(st.segment[3], 1)))
            for path, want in tree_paths(lane):
                assert got[path].dtype == want.dtype, path
                assert _same_bits(got[path].cpu(), want.cpu()), path
        return gas.ctx, st

    ctx, _ = _card_and_cpu_states(cuda, run)
    assert ctx.exchanges == 2


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "xlstm-350m"])
def test_lane_tier_on_the_card_matches_the_cpu(cuda, arch, monkeypatch,
                                                exact_flash):
    """recurrentgemma-smoke and xlstm-smoke (float32) through the tier (2
    + 2 kernels, 2 lanes each) on the card: every landed lane bitwise the
    prefill worker's, 6 migrations at 2 exchanges, no error bit, the CPU
    run's tokens.  (deepseek-v2-smoke's MLA head dims, 24 / 16, have no
    flash kernel on the card: its lane is held by the migration test.)"""
    from repro_torch import configs
    from repro_torch.launch.mesh import ServingSlices
    from repro_torch.serving import DisaggServeTier, Request
    from serving_checks import MAX_NEW, PROMPTS

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = configs.reduced(arch)
    params = None
    outs, landed = {}, []
    for device in ("cpu", cuda):
        model, _, _, transport = _lane_space(cfg, device)
        if params is None:
            params = model.init(torch.Generator().manual_seed(0))
        tier = DisaggServeTier(model, _to(params, device),
                               ServingSlices(2, 2), lanes_per_decode=2,
                               slots=16, transport=transport, device=device)
        migrate = tier.migrate

        def checked(src, dst, lane, lane_cache, migrate=migrate):
            adopted = migrate(src, dst, lane, lane_cache)
            landed.append(all(
                _same_bits(a[key][n].cpu(), w[key][n].cpu())
                for a, w in zip(adopted, lane_cache) for key in w
                for n in w[key]))
            return adopted

        tier.migrate = checked
        done = tier.run([Request(i, np.asarray(p, np.int32), m)
                         for i, (p, m) in enumerate(zip(PROMPTS, MAX_NEW))])
        outs[str(device)] = {r.rid: r.out for r in done}
        assert tier.migrations == len(PROMPTS)
        assert tier.ctx.exchanges == 2 * len(PROMPTS)
        assert int(tier.state.error.abs().sum()) == 0
    assert outs["cpu"] == outs[str(cuda)]
    assert landed == [True] * (2 * len(PROMPTS))


# -- activation checkpointing (ModelConfig.remat) ------------------------------

@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "dbrx-132b"])
def test_remat_on_the_card_matches_none(cuda, monkeypatch, arch):
    """The smoke config (float32, TF32 off) under ``full`` and ``dots``
    against ``none`` on the card: the loss and every gradient leaf
    bitwise wherever a second ``none`` run reproduces the first bitwise
    (every operation deterministic), else within 1e-5 of the leaf's
    largest |gradient|; one checkpoint region a superblock.
    recurrentgemma-smoke's regions recompute the associative scan's
    in-place writes; dbrx-smoke runs the island over 4 kernels x 2 data
    groups (psum, no shared experts: its region reruns no collective, so
    6 ring launches a MoE layer under every policy)."""
    from repro_torch import configs
    from repro_torch.core.state import ShoalContext
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.models import model as tmodel
    from repro_torch.models import moe as tmoe
    from repro_torch.optim import AdamWConfig
    from repro_torch.training import Trainer
    from repro_torch.tree import tree_leaves

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    base = configs.reduced(arch)
    params = _to(tmodel.build_model(base, device="cpu").init(
        torch.Generator().manual_seed(0)), cuda)
    batch, _ = TokenPipeline(DataConfig(vocab=base.vocab, batch=4, seq=16,
                                        seed=0), device=cuda).next_batch(0)
    regions = []
    real = tmodel._checkpointed

    def counted(remat, fn, *args):
        regions.append(remat)
        return real(remat, fn, *args)

    monkeypatch.setattr(tmodel, "_checkpointed", counted)
    runs = []
    for policy in ("none", "full", "dots", "none"):
        cfg = dataclasses.replace(base, remat=policy)
        ep = (tmoe.ExpertMesh(ShoalContext(4, device=cuda), data=2)
              if cfg.family == "moe" else None)
        regions.clear()
        reset_launch_counts()
        loss, grads = Trainer(tmodel.build_model(cfg, device=cuda, ep=ep),
                              AdamWConfig()).value_and_grad(params, batch)
        torch.cuda.synchronize()
        assert regions == ([] if policy == "none" else
                           [policy] * sum(r for _, r in cfg.segments()))
        if ep is not None:
            assert launch_counts()["ring_collective"] == 6 * cfg.n_layers
        runs.append((loss, tree_leaves(grads)))
    (l0, g0), (l1, g1) = runs[0], runs[-1]
    for loss, grads in runs[1:3]:
        if torch.equal(l0, l1):
            assert torch.equal(loss, l0)
        else:
            torch.testing.assert_close(loss, l0, rtol=1e-5, atol=1e-5)
        for a, b, again in zip(grads, g0, g1):
            if torch.equal(b, again):
                assert torch.equal(a, b)
            else:
                torch.testing.assert_close(
                    a, b, rtol=0, atol=1e-5 * b.abs().max().item())


def test_pipeline_on_the_card_matches_the_cpu(cuda, monkeypatch):
    """``chip_smoke.py``'s pipeline check at smoke size (qwen2-smoke at
    8 layers over 4 stages, 3 microbatches of 1 x 16, float32, TF32
    off): on the card the output bitwise the stack's run microbatch by
    microbatch and every gradient within 1e-5 of it; the card's run
    within 1e-5 of the CPU run's, with the same exchanges forward and
    forward + backward."""
    import chip_smoke
    from repro_torch import configs
    from repro_torch.models.model import build_model

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    n, M, S = 4, 3, 16
    cfg = dataclasses.replace(configs.reduced("qwen2-1.5b"), n_layers=8)
    cpu_params = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (M, S)))
    probe = torch.from_numpy(rng.standard_normal(
        (M, 1, S, cfg.d_model)).astype(np.float32))
    runs = {}
    for device in ("cpu", cuda):
        model = build_model(cfg, device=device)
        params = _to(cpu_params, device)
        with torch.no_grad():
            mbs = model._embed_in(params, {"tokens": toks.to(device)})[:, None]
        runs[str(device)] = chip_smoke.pipeline_vs_stack(
            torch, model, params, mbs, probe.to(device), n)
    card, cpu = runs[str(cuda)], runs["cpu"]
    assert card["exchanges"] == cpu["exchanges"] \
        == chip_smoke.pipeline_exchanges(n, M)
    assert torch.equal(card["out"], card["want"])
    torch.testing.assert_close(card["out"].cpu(), cpu["out"], rtol=1e-5,
                               atol=1e-5)
    for g, w, c in zip(card["grads"], card["want_grads"], cpu["grads"]):
        assert chip_smoke._rel_l2(torch, g, w) <= chip_smoke.PIPE_GRAD_TOL
        torch.testing.assert_close(g.cpu(), c, rtol=0,
                                   atol=1e-5 * c.abs().max().item())


def test_train_launcher_restart_on_the_card(cuda, tmp_path, capsys,
                                            monkeypatch):
    """``launch.train`` at the reduced config on the card (shoal, K 2),
    every leaf write slowed: a failure at step 3 restores step 2, the
    checkpoint in flight, and the run ends with its uninterrupted
    twin's checkpoint, leaf for leaf (manifest sha256); one ring launch
    a leaf a step."""
    import json
    import os
    import time

    from repro_torch.checkpoint import checkpoint as ck
    from repro_torch.launch import train as launch_train

    real = ck._save_leaf

    def slow(path, leaf, dtype):
        time.sleep(0.02)
        real(path, leaf, dtype)

    monkeypatch.setattr(ck, "_save_leaf", slow)
    common = ["--reduced", "--device", "cuda", "--steps", "5", "--batch",
              "4", "--seq", "16", "--log-every", "1", "--backend", "shoal",
              "--kernels", "2"]
    rings = {}
    for run, extra in (("crash", ["--fail-at", "3", "--ckpt-every", "2"]),
                       ("straight", ["--ckpt-every", "100"])):
        reset_launch_counts()
        assert launch_train.main(common + ["--ckpt-dir", str(tmp_path / run)]
                                 + extra) == 0
        rings[run] = launch_counts()["ring_collective"]
    out = capsys.readouterr().out
    assert "[launch] restored step 2 (data step 2)" in out
    assert out.count("[launch] done at step 5") == 2

    def manifest(run):
        with open(os.path.join(tmp_path, run, "step_00000005",
                               "manifest.json")) as f:
            return json.load(f)

    a, b = manifest("crash"), manifest("straight")
    assert [(e["path"], e["sha256"]) for e in a["leaves"]] \
        == [(e["path"], e["sha256"]) for e in b["leaves"]]
    leaves = rings["straight"] // 5
    assert rings == {"crash": 6 * leaves, "straight": 5 * leaves}
