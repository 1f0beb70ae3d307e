"""The cluster ring kernel, decided and modelled on the CPU.

``kernels.gascore_dma`` has two ring kernels: the Hopper kernel
(``csrc/gascore_dma_sm90.cu``: a thread-block cluster of K CTAs, one
per Shoal kernel, puts into the other CTAs' shared memory, mbarrier
receive and capacity semaphores) for 2 <= K <= 8 and small chunks, and
the simple kernel (``csrc/gascore_dma.cu``) for the rest it holds.
Both run only on the card (``tests/test_torch_cuda.py``); here
``ring_kernel_for``'s routes, ``cluster_tile_plan``'s grids and
refusals, the build registry and the counters are checked without one,
and the cluster kernel's protocol -- the puts into a slot per sender,
the folds in the ring's order, the receive semaphore and the credits
that guard the all-reduce's reuse of the slots -- is replayed in plain
Python under random interleavings of the K CTAs and held bitwise to
the plain versions, which ``tests/test_torch_collectives.py`` holds to
the JAX package.
"""

import random
import re

import pytest
import torch

from repro_torch.kernels import LAUNCH_COUNTERS, _build
from repro_torch.kernels import gascore_dma as gd
from repro_torch.kernels.gascore_dma import gascore_dma as gdm

DTYPES = [torch.float32, torch.bfloat16, torch.int32]
SCHEDULES = [gd.DMA, gd.REDUCE_SCATTER, gd.ALL_GATHER, gd.ALL_REDUCE]
SM90_SRC = _build.SOURCES["gascore_dma_sm90"]


# -- routes ------------------------------------------------------------------

@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("K", [1, 2, 3, 8, 9, 17, 200])
def test_ring_kernel_for_sends_small_collectives_to_the_cluster_kernel(
        K, dtype, schedule):
    """The cluster kernel takes chunks of 1 to 16 KiB of the
    reduce-scatter on 2..8 kernels and of the all-gather and all-reduce
    on 8, where scripts/ring_sweep.py measured it faster; everything
    else goes to the simple kernel."""
    lo = gdm.CLUSTER_MIN_CHUNK_BYTES // dtype.itemsize
    hi = gdm.CLUSTER_MAX_CHUNK_BYTES // dtype.itemsize
    cluster = (2 <= K <= 8 if schedule == gd.REDUCE_SCATTER
               else K == 8 and schedule != gd.DMA)
    for words in (lo, hi, (lo + hi) // 2):
        assert gd.ring_kernel_for(K, words, dtype, schedule) == (
            "sm90" if cluster else "simple")
    for words in (1, lo - 1, hi + 1, 65_536_000):
        assert gd.ring_kernel_for(K, words, dtype, schedule) == "simple"


def test_main_path_shapes_take_the_measured_kernel():
    """Phase 5's float32 shapes on 8 kernels: the 1 MB reduce-scatter and
    all-gather (chunks of 4096 words) and tinyllama-1.1b's norm leaf
    (2048 words all-reduced, chunks of 256) to the cluster kernel; the
    compressed leaf's 1-word scale and the embedding leaf (65,536,000
    words, chunks of 8,192,000) to the simple kernel."""
    f32 = torch.float32
    for words, schedule in ((4096, gd.REDUCE_SCATTER), (4096, gd.ALL_GATHER),
                            (256, gd.ALL_REDUCE)):
        assert gd.ring_kernel_for(8, words, f32, schedule) == "sm90"
    for words, schedule in ((1, gd.ALL_REDUCE), (8_192_000, gd.ALL_REDUCE),
                            (65_536_000, gd.DMA)):
        assert gd.ring_kernel_for(8, words, f32, schedule) == "simple"


def test_other_types_go_to_the_simple_kernel():
    assert gd.ring_kernel_for(8, 64, torch.float64, gd.DMA) == "simple"
    assert gd.ring_kernel_for(8, 64, torch.float16, gd.ALL_REDUCE) == "simple"


# -- the cluster tile plan ---------------------------------------------------

@pytest.mark.parametrize("schedule", [gd.REDUCE_SCATTER, gd.ALL_GATHER,
                                      gd.ALL_REDUCE])
def test_plan_fills_the_card_at_one_megabyte(schedule):
    """bench_throughput.py's 1 MB on 8 kernels: chunks of 4096 words.
    The simple kernel ran 32 CTAs there."""
    plan = gd.cluster_tile_plan(8, 4096, torch.float32, schedule)
    assert plan.ctas >= 128 and plan.ctas == 8 * plan.tiles
    assert plan.vec == 4                      # 16-byte vectors
    assert plan.threads * plan.vt * plan.vec * plan.tiles >= 4096


def test_plan_spreads_the_norm_leaf_over_sixteen_ctas():
    """tinyllama-1.1b's RMSNorm gain (2048 words) as the ring all-reduce
    cuts it: 8 chunks of 256 words.  The simple kernel ran 2 CTAs."""
    plan = gd.cluster_tile_plan(8, 2048 // 8, torch.float32, gd.ALL_REDUCE)
    assert plan.ctas >= 16
    old_ctas = -(-(2048 // 8 // 4) // gd.tile_plan(8, 256, torch.float32,
                                                   gd.ALL_REDUCE)[0])
    assert old_ctas == 2


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_plan_keeps_vectors_in_flight_at_the_embedding_leaf(dtype, schedule):
    """tinyllama-1.1b's embedding gradient, 8 x 65,536,000 words: full
    CTAs of 16-byte vectors, 4 a thread for the dma and all-gather
    schedules, all 8 chunks of a thread for the reduce-scatter ones."""
    words = 65_536_000 if schedule in (gd.DMA, gd.ALL_GATHER) \
        else 65_536_000 // 8
    plan = gd.cluster_tile_plan(8, words, dtype, schedule)
    assert plan.threads == 256 and plan.vec * dtype.itemsize == 16
    assert plan.vt == (4 if schedule in (gd.DMA, gd.ALL_GATHER) else 1)
    assert plan.ctas >= 132 and plan.smem <= gdm.MAX_SMEM


def test_plan_falls_back_to_words_when_vectors_do_not_fit():
    for words, aligned in ((37, True), (4099, True), (4096, False)):
        plan = gd.cluster_tile_plan(3, words, torch.bfloat16, gd.DMA,
                                    aligned)
        assert plan.vec == 1
        # a 2-byte word travels in a 4-byte DSMEM store
        assert plan.smem == gdm.cluster_smem_bytes(3, plan.threads, plan.vt,
                                                   4)


@pytest.mark.parametrize("K", [2, 5, 8])
def test_plan_smem_is_the_barriers_and_a_slot_per_other_rank(K):
    plan = gd.cluster_tile_plan(K, 65_536_000, torch.float32, gd.DMA)
    assert plan.smem == gdm.BAR_BYTES + (K - 1) * 256 * 4 * 16


@pytest.mark.parametrize("K", [0, 1, 9, 17, 200])
def test_plan_refuses_rings_beyond_the_cluster_naming_its_limits(K):
    with pytest.raises(ValueError, match=r"cluster ring kernel .*"
                       r"2 <= K <= 8 .*does not fit"):
        gd.cluster_tile_plan(K, 4096, torch.float32, gd.ALL_REDUCE)


def test_plan_refuses_other_types_and_empty_chunks():
    with pytest.raises(TypeError, match="float32, bfloat16 and int32"):
        gd.cluster_tile_plan(8, 4096, torch.float64, gd.DMA)
    with pytest.raises(ValueError, match="a word"):
        gd.cluster_tile_plan(8, 0, torch.float32, gd.DMA)
    with pytest.raises(ValueError, match="unknown schedule"):
        gd.cluster_tile_plan(8, 64, torch.float32, "broadcast")


def test_forced_kernels_name_the_limits_of_the_kernel_asked_for():
    """``kernel="sm90"`` refuses what the cluster kernel cannot hold and
    says so, and takes a chunk the route sends to the simple kernel; the
    simple kernel's refusal names its own limits."""
    x = torch.empty(0)
    assert gdm._route(x, 8, 65_536_000, gd.DMA, None) == "simple"
    assert gdm._route(x, 8, 65_536_000, gd.DMA, "sm90") == "sm90"
    with pytest.raises(ValueError, match="cluster ring kernel"):
        gdm._route(x, 200, 4, gd.ALL_REDUCE, "sm90")
    assert gdm._route(x, 200, 4, gd.ALL_REDUCE, "simple") == "simple"
    assert gdm._route(x, 8, 256, gd.ALL_REDUCE, None) == "sm90"
    assert gdm._route(x, 8, 256, gd.ALL_REDUCE, "simple") == "simple"
    assert gdm._route(x, 1, 4, gd.DMA, None) == "simple"
    with pytest.raises(ValueError, match="kernel must be one of"):
        gdm._route(x, 8, 4, gd.DMA, "fast")
    with pytest.raises(ValueError, match=r"simple ring kernel .*K <= 119 "
                       r".*K=200 does not fit"):
        gd.tile_plan(200, 4096, torch.float32, gd.ALL_REDUCE)


def test_wrappers_refuse_cpu_tensors_whatever_the_kernel():
    for kernel in (None, "sm90", "simple"):
        with pytest.raises(ValueError, match="CUDA"):
            gd.ring_allreduce_dma_cuda(torch.ones(8, 4), kernel=kernel)
        with pytest.raises(ValueError, match="CUDA"):
            gd.ring_collective_cuda(torch.ones(8, 8, 4), gd.ALL_REDUCE,
                                    kernel=kernel)


# -- the build and the counters ----------------------------------------------

def test_build_registers_the_cluster_source_for_sm90a():
    assert SM90_SRC.name == "gascore_dma_sm90.cu" and SM90_SRC.exists()
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    text = SM90_SRC.read_text()
    for ptx in ("mbarrier.try_wait.parity.acquire.cluster",
                "mbarrier.arrive.release.cluster.shared::cluster",
                "st.async.shared::cluster.mbarrier::complete_tx::bytes",
                "mapa.shared::cluster", "barrier.cluster.arrive",
                "cudaLaunchAttributeClusterDimension", "cudaLaunchKernelEx",
                "cudaOccupancyMaxActiveClusters"):
        assert ptx in text
    # chip_smoke.py's device_ms tells the kernels apart by a substring of
    # their device-side names
    kernels = {name: re.findall(r"__global__ void\s+(?:__launch_bounds__"
                                r"\(\w+\)\s+)?(\w+)\(",
                                _build.SOURCES[name].read_text())
               for name in ("gascore_dma", "gascore_dma_sm90")}
    assert kernels == {"gascore_dma": ["ring_kernel"],
                       "gascore_dma_sm90": ["ring_cluster_kernel_sm90"]}
    assert _build.library_path("gascore_dma_sm90").name.startswith(
        "libgascore_dma_sm90")


def test_counters_name_both_ring_kernels():
    assert LAUNCH_COUNTERS["ring_cluster_sm90"] is gd.launch_ring_sm90
    assert LAUNCH_COUNTERS["ring_collective"] is gd.ring_collective_cuda
    assert LAUNCH_COUNTERS["ring_allreduce_dma"] is gd.ring_allreduce_dma_cuda


# -- the protocol, replayed ----------------------------------------------------

def _cluster_ring(x, schedule, rng):
    """The cluster kernel's protocol in plain Python, one warp per CTA:
    rank ``k`` of ``n`` runs its steps as ``csrc/gascore_dma_sm90.cu``
    does (``Cluster::put``, ``receive`` and ``credit``, and each
    schedule's folds), and a random scheduler interleaves the ranks,
    each blocked only at its waits.  Checks the semaphores' rules on the
    way: no put before every rank has its barriers, a put lands only in
    a slot whose last contents were read, a phase is read only once all
    its bytes landed.  Returns what the kernel writes."""
    n = x.shape[0]
    inited = [False] * n
    landed = [0] * n                    # puts that completed full[k]
    credits = [0] * n                   # arrivals on empty[k]
    inbox = [[None] * (n - 1) for _ in range(n)]
    writes = [[0] * (n - 1) for _ in range(n)]
    reads = [[0] * (n - 1) for _ in range(n)]
    if schedule == gd.DMA:
        out = x.clone()
    elif schedule == gd.REDUCE_SCATTER:
        out = x.new_zeros((n,) + x.shape[2:])
    else:
        out = x.new_zeros((n, n) + x.shape[-1:])

    def rank(k):
        def put(dst, v):
            s = (k - dst - 1) % n
            assert writes[dst][s] == reads[dst][s]      # capacity
            inbox[dst][s] = v
            writes[dst][s] += 1
            landed[dst] += 1                            # complete_tx
            yield lambda: True

        def receive(phase):
            yield lambda: landed[k] >= (n - 1) * (phase + 1)
            got = list(inbox[k])
            for s in range(n - 1):
                reads[k][s] += 1
            return got

        inited[k] = True                                # init, then the
        yield lambda: all(inited)                       # cluster barrier
        phase = 0
        if schedule in (gd.REDUCE_SCATTER, gd.ALL_REDUCE):
            for c in range(n):
                if c != k:
                    yield from put(c, x[k, c])
            slots = yield from receive(0)
            s = slots[0]                                # x[k+1, k]
            for i in range(1, n - 1):
                s = slots[i] + s                        # cur + recv
            own = x[k, k] + s
            if schedule == gd.REDUCE_SCATTER:
                out[k] = own
                return
            for d in range(1, n):                       # credit()
                credits[(k + d) % n] += 1
            yield lambda: credits[k] >= n - 1
            phase = 1
        else:
            own = x[k]
        for d in range(1, n):
            yield from put((k + d) % n, own)
        slots = yield from receive(phase)
        if schedule == gd.DMA:
            o = own
            for i in range(n - 2, -1, -1):              # x[k-1], x[k-2] ..
                o = o + slots[i]
            out[k] = o
            return
        out[k, k] = own
        for i in range(n - 1):
            out[k, (k + 1 + i) % n] = slots[i]

    running = {k: rank(k) for k in range(n)}
    blocked = {k: (lambda: True) for k in running}
    while running:
        ready = [k for k in running if blocked[k]()]
        assert ready, "the cluster deadlocked"
        k = rng.choice(ready)
        try:
            blocked[k] = next(running[k])
        except StopIteration:
            del running[k]
    for k in range(n):                   # every put was read
        assert writes[k] == reads[k]
    return out


def _input(K, shape, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    if dtype == torch.int32:
        return torch.randint(-127, 128, (K,) + shape, generator=gen,
                             dtype=torch.int32)
    return torch.randn((K,) + shape, generator=gen).to(dtype)


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("K", [2, 3, 5, 8])
def test_cluster_protocol_matches_the_plain_version_bitwise(K, schedule):
    rng = random.Random(K * 10 + SCHEDULES.index(schedule))
    for i, dtype in enumerate(DTYPES):
        shape = (37,) if schedule in (gd.DMA, gd.ALL_GATHER) else (K, 37)
        x = _input(K, shape, dtype, i)
        want = (gd.ring_allreduce_dma_ref(x) if schedule == gd.DMA
                else gd.ring_collective_ref(x, schedule))
        for _ in range(4):           # four interleavings of the CTAs
            got = _cluster_ring(x, schedule, rng)
            assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
