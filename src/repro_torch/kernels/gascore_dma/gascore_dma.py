"""ctypes binding of the ring kernel in ``csrc/gascore_dma.cu``.

Both functions take CUDA tensors only, check them, launch on PyTorch's
current stream and raise if the launch fails.  Each keeps a plain
integer count of its launches (``ring_allreduce_dma_cuda.launches``).
:func:`tile_plan` picks the kernel's tile from K and refuses a K the
kernel cannot hold; it is plain arithmetic, so it runs anywhere.  The
library is built at first use (:mod:`repro_torch.kernels._build`).
"""

from __future__ import annotations

import ctypes

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
        raise ValueError(
            f"the ring kernel holds K <= {MAX_THREADS} kernels for the dma "
            f"schedule and fewer for the collective ones (K*K*{V * elt} "
            f"bytes of shared memory per thread column); K={K} with "
            f"schedule {schedule!r} does not fit")
    return R, V


def _lib():
    lib = _build.load("gascore_dma")
    if not getattr(lib, "_typed", False):
        lib.ring_collective.argtypes = [_P, _P, _I, _L, _I, _I, _I, _I, _P]
        lib.ring_collective.restype = _I
        lib.ring_error_string.argtypes = [_I]
        lib.ring_error_string.restype = ctypes.c_char_p
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


def _launch(x: torch.Tensor, out: torch.Tensor, K: int, words: int,
            schedule: str) -> None:
    aligned = x.data_ptr() % VEC_BYTES == 0 and out.data_ptr() % VEC_BYTES == 0
    R, V = tile_plan(K, words, x.dtype, schedule, aligned)
    lib = _lib()
    status = lib.ring_collective(
        x.data_ptr(), out.data_ptr(), K, words, _DTYPES[x.dtype],
        _SCHEDULES[schedule], R, V,
        torch.cuda.current_stream(x.device).cuda_stream)
    if status != 0:
        msg = lib.ring_error_string(status).decode()
        raise RuntimeError(f"ring kernel ({schedule}): CUDA error {status} "
                           f"({msg})")


def ring_allreduce_dma_cuda(x: torch.Tensor) -> torch.Tensor:
    """Kernel version of :func:`..ref.ring_allreduce_dma_ref` over
    ``x (K, chunk)``."""
    if x.dim() != 2:
        raise ValueError(f"x must be (K, chunk), got {tuple(x.shape)}")
    _check(x, x.shape)
    out = torch.empty_like(x)
    if x.numel():
        _launch(x, out, x.shape[0], x.shape[1], DMA)
        ring_allreduce_dma_cuda.launches += 1
    return out


def ring_collective_cuda(x: torch.Tensor, schedule: str) -> torch.Tensor:
    """Kernel version of :func:`..ref.ring_collective_ref`:
    ``reduce_scatter`` ``(K, K, c) -> (K, c)``, ``all_gather``
    ``(K, c) -> (K, K, c)``, ``all_reduce`` ``(K, K, c) -> (K, K, c)``,
    one launch each."""
    if schedule not in (REDUCE_SCATTER, ALL_GATHER, ALL_REDUCE):
        raise ValueError(f"unknown ring collective schedule {schedule!r}")
    K, c = x.shape[0], x.shape[-1]
    _check(x, (K, c) if schedule == ALL_GATHER else (K, K, c))
    shape = (K, c) if schedule == REDUCE_SCATTER else (K, K, c)
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    if x.numel():
        _launch(x, out, K, c, schedule)
        ring_collective_cuda.launches += 1
    return out


ring_allreduce_dma_cuda.launches = 0
ring_collective_cuda.launches = 0
