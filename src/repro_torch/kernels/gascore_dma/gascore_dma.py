"""ctypes bindings of the two ring kernels.

* ``csrc/gascore_dma_sm90.cu`` (``ring_cluster_sm90``): the Hopper
  kernel -- a thread-block cluster of K CTAs, one per Shoal kernel, puts
  into the other CTAs' shared memory, mbarrier receive and capacity
  semaphores -- for the collective schedules at chunks of 1 to 16 KiB
  (the reduce-scatter on 2 <= K <= 8 kernels, the others on 8).
* ``csrc/gascore_dma.cu`` (``ring_collective``): the simple kernel, one
  CTA holding a tile of words for all K kernels, for the rest it holds
  (the dma schedule, K = 1, K > 8, smaller and larger chunks).

:func:`ring_kernel_for` decides between them from the schedule, K, the
dtype and the chunk length alone, before the launch; nothing is
retried.  :func:`cluster_tile_plan` and :func:`tile_plan` pick each
kernel's tile and refuse what it cannot hold, naming its limits; both
are plain arithmetic, so they run anywhere.  The wrappers take CUDA
tensors only, check them, launch on PyTorch's current stream and raise
if the launch fails (a refused cluster launch included).  Launches are
counted on ``ring_allreduce_dma_cuda.launches`` and
``ring_collective_cuda.launches`` (either kernel) and on
``launch_ring_sm90.launches`` (the cluster kernel alone).  The libraries
are built at first use (:mod:`repro_torch.kernels._build`).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gascore_dma.ref import (ALL_GATHER, ALL_REDUCE, DMA,
                                                 REDUCE_SCATTER)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
_SCHEDULES = {DMA: 0, REDUCE_SCATTER: 1, ALL_GATHER: 2, ALL_REDUCE: 3}
MAX_THREADS = 1024          # threads of one CTA
MAX_SMEM = 232448           # dynamic shared memory of one CTA (227 KB)
THREADS = 256               # the CTA size the plan aims for
VEC_BYTES = 16              # one vector load or store
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
KERNELS = ("sm90", "simple")
CLUSTER_MAX = 8             # the portable thread-block cluster size
CLUSTER_THREADS = 256       # the CTA size the cluster plan starts from
CLUSTER_VT = 4              # vectors per thread it starts from (dma, ag)
SM_COUNT = 132              # SMs of an H100 SXM: the grid the plan fills
BAR_BYTES = 128             # the cluster kernel's mbarriers
# ring_kernel_for's routes, from scripts/ring_sweep.py (PERF.md): the
# cluster kernel beat the simple one in both turns for these schedules,
# from this many kernels up, at these chunk lengths, and lost or tied
# outside them -- below, to its cluster launch and barriers; above, to
# distributed shared memory's bandwidth, where the simple kernel's ring
# stays inside one SM; at fewer kernels, to the simple kernel's shorter
# ring.  It lost the dma schedule (every word through DSMEM K - 1 times)
# at every length and K measured.
CLUSTER_MIN_K = {REDUCE_SCATTER: 2, ALL_GATHER: 8, ALL_REDUCE: 8}
CLUSTER_MIN_CHUNK_BYTES = 1 << 10
CLUSTER_MAX_CHUNK_BYTES = 1 << 14


def smem_bytes(K: int, R: int, vec_bytes: int, schedule: str) -> int:
    """Shared memory of one CTA: the double-buffered inbox, plus every
    kernel's ``n = K`` chunk vectors for the collective schedules
    (``smem_bytes`` in the source, which checks the plan again)."""
    per = K * R * vec_bytes
    return 2 * per if schedule == DMA else (2 + K) * per


def tile_plan(K: int, words: int, dtype: torch.dtype, schedule: str,
              aligned: bool = True) -> tuple[int, int]:
    """``(R, V)``: ``R`` threads per kernel row (``K * R`` per CTA) and
    ``V`` words per thread, for a chunk of ``words`` elements.  Vectors
    of 16 bytes when the chunk and the pointers allow, else one word.
    Raises ``ValueError`` for a K the kernel cannot hold."""
    elt = torch.empty((), dtype=dtype).element_size()
    V = VEC_BYTES // elt
    if words % V or not aligned:
        V = 1
    R = 1 << (max(THREADS // K, 1).bit_length() - 1)
    while R > 1 and smem_bytes(K, R, V * elt, schedule) > MAX_SMEM:
        R //= 2
    if K * R > MAX_THREADS or smem_bytes(K, R, V * elt, schedule) > MAX_SMEM:
        kmax = max(k for k in range(1, MAX_THREADS + 1)
                   if smem_bytes(k, 1, V * elt, schedule) <= MAX_SMEM)
        raise ValueError(
            f"the simple ring kernel (csrc/gascore_dma.cu) holds "
            f"K <= {kmax} kernels for schedule {schedule!r} at "
            f"{V * elt}-byte vectors (one CTA of K threads at most "
            f"{MAX_THREADS}, {MAX_SMEM} bytes of shared memory); K={K} "
            f"does not fit")
    return R, V


class ClusterPlan(NamedTuple):
    """The cluster kernel's launch: ``threads`` per CTA, ``vt`` vectors
    of ``vec`` words per thread, ``tiles`` clusters of K CTAs
    (``ctas`` in all), ``smem`` bytes of shared memory per CTA."""
    threads: int
    vt: int
    vec: int
    tiles: int
    ctas: int
    smem: int


def cluster_smem_bytes(K: int, threads: int, vt: int,
                       wire_bytes: int) -> int:
    """Shared memory of one cluster CTA: the mbarriers and the inbox, a
    slot for each of the K - 1 other ranks (``smem_bytes`` in the source,
    which checks the plan again)."""
    return BAR_BYTES + (K - 1) * threads * vt * wire_bytes


def cluster_tile_plan(K: int, words: int, dtype: torch.dtype, schedule: str,
                      aligned: bool = True) -> ClusterPlan:
    """The cluster kernel's tile for a chunk of ``words`` elements on K
    kernels.  16-byte vectors when the chunk and the pointers allow,
    else one word.  From 256 threads of 4 vectors (1 for the
    reduce-scatter schedules, which keep all n chunks of a thread in
    flight), vectors per thread and then threads per CTA halve until the
    grid holds at least ``SM_COUNT`` CTAs or a CTA is one warp of one
    vector.  Raises ``ValueError`` for a K outside the cluster's
    ``2 <= K <= 8`` and ``TypeError`` for a type it does not add."""
    if not 2 <= K <= CLUSTER_MAX:
        raise ValueError(
            f"the cluster ring kernel (csrc/gascore_dma_sm90.cu) holds "
            f"2 <= K <= {CLUSTER_MAX} kernels, one CTA each in a portable "
            f"thread-block cluster; K={K} does not fit")
    if dtype not in _DTYPES:
        raise TypeError(f"the ring kernel adds float32, bfloat16 and int32, "
                        f"got {dtype}")
    if schedule not in _SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r}")
    if words < 1:
        raise ValueError(f"the chunk must hold a word, got {words}")
    elt = torch.empty((), dtype=dtype).element_size()
    vec = VEC_BYTES // elt
    if words % vec or not aligned:
        vec = 1
    C = words // vec
    threads = CLUSTER_THREADS
    vt = CLUSTER_VT if schedule in (DMA, ALL_GATHER) else 1

    def tiles():
        return -(-C // (threads * vt))

    while K * tiles() < SM_COUNT and (vt > 1 or threads > 32):
        if vt > 1:
            vt //= 2
        else:
            threads //= 2
    if K * tiles() > 2 ** 31 - 1:
        raise ValueError(f"the cluster ring kernel's grid holds 2**31 - 1 "
                         f"CTAs; {K} x {tiles()} does not fit")
    smem = cluster_smem_bytes(K, threads, vt, max(vec * elt, 4))
    return ClusterPlan(threads, vt, vec, tiles(), K * tiles(), smem)


def ring_kernel_for(K: int, words: int, dtype: torch.dtype,
                    schedule: str) -> str:
    """``"sm90"`` where the cluster kernel was measured faster: a schedule
    of ``CLUSTER_MIN_K`` on ``CLUSTER_MIN_K[schedule] <= K <= 8``
    kernels, float32, bfloat16 or int32, chunks of
    ``CLUSTER_MIN_CHUNK_BYTES`` to ``CLUSTER_MAX_CHUNK_BYTES``; else
    ``"simple"``.  A pure function of its arguments, decided before the
    launch."""
    if CLUSTER_MIN_K.get(schedule, CLUSTER_MAX + 1) <= K <= CLUSTER_MAX \
            and dtype in _DTYPES \
            and CLUSTER_MIN_CHUNK_BYTES <= words * dtype.itemsize \
            <= CLUSTER_MAX_CHUNK_BYTES:
        return "sm90"
    return "simple"


def _lib():
    lib = _build.load("gascore_dma")
    if not getattr(lib, "_typed", False):
        lib.ring_collective.argtypes = [_P, _P, _I, _L, _I, _I, _I, _I, _P]
        lib.ring_collective.restype = _I
        lib.ring_error_string.argtypes = [_I]
        lib.ring_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _lib_sm90():
    lib = _build.load("gascore_dma_sm90")
    if not getattr(lib, "_typed", False):
        lib.ring_cluster_sm90.argtypes = [_P, _P, _I, _L, _I, _I, _I, _I, _I,
                                          _P]
        lib.ring_cluster_sm90.restype = _I
        lib.ring_cluster_sm90_max_active.argtypes = [
            _I, _L, _I, _I, _I, _I, _I, ctypes.POINTER(_I)]
        lib.ring_cluster_sm90_max_active.restype = _I
        lib.ring_cluster_sm90_error_string.argtypes = [_I]
        lib.ring_cluster_sm90_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check(x: torch.Tensor, shape) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"the ring kernel takes CUDA tensors, got {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"the ring kernel adds float32, bfloat16 and int32, "
                        f"got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"ring input has shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError("ring input must be contiguous")


def _aligned(x: torch.Tensor, out: torch.Tensor) -> bool:
    return x.data_ptr() % VEC_BYTES == 0 and out.data_ptr() % VEC_BYTES == 0


def cluster_max_active(K: int, words: int, dtype: torch.dtype,
                       schedule: str) -> int:
    """``cudaOccupancyMaxActiveClusters`` of the cluster kernel's plan for
    these inputs (16-byte aligned tensors): how many clusters of K CTAs
    the card holds at once.  Needs the card."""
    plan = cluster_tile_plan(K, words, dtype, schedule)
    lib = _lib_sm90()
    clusters = _I(0)
    status = lib.ring_cluster_sm90_max_active(
        K, words, _DTYPES[dtype], _SCHEDULES[schedule], plan.threads,
        plan.vt, plan.vec, ctypes.byref(clusters))
    if status != 0:
        msg = lib.ring_cluster_sm90_error_string(status).decode()
        raise RuntimeError(f"cluster ring kernel occupancy: CUDA error "
                           f"{status} ({msg})")
    return clusters.value


def launch_ring_sm90(x: torch.Tensor, out: torch.Tensor, K: int, words: int,
                     schedule: str) -> None:
    """Launch the cluster kernel on checked inputs, one cluster per tile;
    raises if the plan or the launch is refused
    (``cudaErrorClusterOutOfResources`` included)."""
    plan = cluster_tile_plan(K, words, x.dtype, schedule, _aligned(x, out))
    lib = _lib_sm90()
    status = lib.ring_cluster_sm90(
        x.data_ptr(), out.data_ptr(), K, words, _DTYPES[x.dtype],
        _SCHEDULES[schedule], plan.threads, plan.vt, plan.vec,
        torch.cuda.current_stream(x.device).cuda_stream)
    if status != 0:
        msg = lib.ring_cluster_sm90_error_string(status).decode()
        raise RuntimeError(f"cluster ring kernel ({schedule}): CUDA error "
                           f"{status} ({msg})")
    launch_ring_sm90.launches += 1


def _route(x: torch.Tensor, K: int, words: int, schedule: str,
           kernel: str | None) -> str:
    """:func:`ring_kernel_for`'s choice, or the forced ``kernel``;
    ``"sm90"`` raises (naming the cluster kernel's limits) on inputs the
    cluster kernel does not take."""
    if kernel is None:
        return ring_kernel_for(K, words, x.dtype, schedule)
    if kernel not in KERNELS:
        raise ValueError(f"kernel must be one of {KERNELS}, got {kernel!r}")
    if kernel == "sm90":
        cluster_tile_plan(K, words, x.dtype, schedule)
    return kernel


def _launch(x: torch.Tensor, out: torch.Tensor, K: int, words: int,
            schedule: str, kernel: str | None = None) -> None:
    if _route(x, K, words, schedule, kernel) == "sm90":
        launch_ring_sm90(x, out, K, words, schedule)
        return
    R, V = tile_plan(K, words, x.dtype, schedule, _aligned(x, out))
    lib = _lib()
    status = lib.ring_collective(
        x.data_ptr(), out.data_ptr(), K, words, _DTYPES[x.dtype],
        _SCHEDULES[schedule], R, V,
        torch.cuda.current_stream(x.device).cuda_stream)
    if status != 0:
        msg = lib.ring_error_string(status).decode()
        raise RuntimeError(f"ring kernel ({schedule}): CUDA error {status} "
                           f"({msg})")


def ring_allreduce_dma_cuda(x: torch.Tensor,
                            kernel: str | None = None) -> torch.Tensor:
    """Kernel version of :func:`..ref.ring_allreduce_dma_ref` over
    ``x (K, chunk)``.  The kernel is :func:`ring_kernel_for`'s choice;
    ``kernel="simple"`` forces the simple one (for comparisons: nothing
    on the main path sets it), ``kernel="sm90"`` raises on inputs the
    cluster kernel does not take."""
    if x.dim() != 2:
        raise ValueError(f"x must be (K, chunk), got {tuple(x.shape)}")
    _check(x, x.shape)
    out = torch.empty_like(x)
    if x.numel():
        _launch(x, out, x.shape[0], x.shape[1], DMA, kernel)
        ring_allreduce_dma_cuda.launches += 1
    return out


def ring_collective_cuda(x: torch.Tensor, schedule: str,
                         kernel: str | None = None) -> torch.Tensor:
    """Kernel version of :func:`..ref.ring_collective_ref`:
    ``reduce_scatter`` ``(K, K, c) -> (K, c)``, ``all_gather``
    ``(K, c) -> (K, K, c)``, ``all_reduce`` ``(K, K, c) -> (K, K, c)``,
    one launch each; ``kernel`` as for :func:`ring_allreduce_dma_cuda`."""
    if schedule not in (REDUCE_SCATTER, ALL_GATHER, ALL_REDUCE):
        raise ValueError(f"unknown ring collective schedule {schedule!r}")
    K, c = x.shape[0], x.shape[-1]
    _check(x, (K, c) if schedule == ALL_GATHER else (K, K, c))
    shape = (K, c) if schedule == REDUCE_SCATTER else (K, K, c)
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    if x.numel():
        _launch(x, out, K, c, schedule, kernel)
        ring_collective_cuda.launches += 1
    return out


ring_allreduce_dma_cuda.launches = 0
ring_collective_cuda.launches = 0
launch_ring_sm90.launches = 0
