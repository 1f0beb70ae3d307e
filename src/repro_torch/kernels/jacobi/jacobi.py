"""ctypes binding of the Jacobi kernel in ``csrc/jacobi.cu``.

:func:`jacobi_sweep_cuda` takes CUDA tensors only, checks them, launches
on PyTorch's current stream, raises if the launch fails, and counts its
launches in ``jacobi_sweep_cuda.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _lib():
    lib = _build.load("jacobi")
    if not getattr(lib, "_typed", False):
        lib.jacobi_sweep.argtypes = [_P, _L, _I, _P, _L, _I, _I, _I, _I, _I,
                                     _P]
        lib.jacobi_sweep.restype = _I
        lib.jacobi_error_string.argtypes = [_I]
        lib.jacobi_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def jacobi_sweep_cuda(x: torch.Tensor, out: torch.Tensor,
                      in_row0: int) -> torch.Tensor:
    """One sweep of ``K`` bands: ``x (K, R, N)`` contiguous, ``out (K,
    rows, N)`` with contiguous rows (bands may sit ``out.stride(0)``
    apart, e.g. the interior of a padded buffer).  Output row ``r`` of
    band ``k`` is global row ``k*rows + r`` of a ``K*rows``-row grid and
    reads input rows ``r + in_row0 - 1 .. r + in_row0 + 1``."""
    if x.device.type != "cuda" or out.device != x.device:
        raise ValueError(f"jacobi_sweep_cuda takes CUDA tensors, got "
                         f"{x.device} and {out.device}")
    if x.dtype not in _DTYPES or out.dtype != x.dtype:
        raise TypeError(f"jacobi kernel takes float32/bfloat16, got "
                        f"{x.dtype} -> {out.dtype}")
    if x.dim() != 3 or out.dim() != 3 or not x.is_contiguous():
        raise ValueError("x must be a contiguous (K, R, N) tensor and out "
                         "a (K, rows, N) tensor")
    K, R, n = x.shape
    rows = out.shape[1]
    if out.shape[0] != K or out.shape[2] != n \
            or out.stride(2) != 1 or out.stride(1) != n:
        raise ValueError(f"out {tuple(out.shape)} with strides "
                         f"{out.stride()} does not hold (K, rows, N) rows")
    if in_row0 not in (0, 1) or rows + 2 * in_row0 > R:
        raise ValueError(f"in_row0={in_row0} with {rows} output rows "
                         f"needs more than the {R} input rows")
    lib = _lib()
    status = lib.jacobi_sweep(
        x.data_ptr(), R * n, in_row0, out.data_ptr(), out.stride(0), K, rows,
        n, K * rows, _DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    if status != 0:
        raise RuntimeError(f"jacobi_sweep: CUDA error {status} "
                           f"({lib.jacobi_error_string(status).decode()})")
    jacobi_sweep_cuda.launches += 1
    return out


jacobi_sweep_cuda.launches = 0
