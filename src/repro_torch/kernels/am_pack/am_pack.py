"""ctypes binding of the DataMover kernels in ``csrc/am_pack.cu``.

Both functions take CUDA tensors only, check them, launch on PyTorch's
current stream and raise if the launch fails.  Each keeps a plain
integer count of its launches (``datamover_gather_cuda.launches``).
The library is built at first use (:mod:`repro_torch.kernels._build`).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.int32: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib():
    lib = _build.load("am_pack")
    if not getattr(lib, "_typed", False):
        lib.datamover_gather.argtypes = [_P, _I, _I, _P, _P, _I, _I, _P, _I,
                                         _P]
        lib.datamover_gather.restype = _I
        lib.datamover_scatter.argtypes = [_P, _I, _I, _P, _P, _P, _P, _P,
                                          _I, _I, _I, _P]
        lib.datamover_scatter.restype = _I
        lib.datamover_error_string.argtypes = [_I]
        lib.datamover_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check_status(lib, status: int, what: str) -> None:
    if status != 0:
        msg = lib.datamover_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({msg})")


def _check(t: torch.Tensor, name: str, shape, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_seg(seg: torch.Tensor) -> None:
    if seg.device.type != "cuda":
        raise ValueError(f"DataMover kernels take CUDA tensors, got "
                         f"{seg.device}")
    if seg.dim() != 2 or not seg.is_contiguous():
        raise ValueError("segment must be a contiguous (K, S) tensor")
    if seg.dtype not in _DTYPES:
        raise TypeError(f"DataMover kernels move float32/int32 words, got "
                        f"{seg.dtype}")


def datamover_gather_cuda(seg: torch.Tensor, addr: torch.Tensor,
                          nwords: torch.Tensor, W: int) -> torch.Tensor:
    """Kernel version of :func:`..ref.datamover_gather_ref`."""
    _check_seg(seg)
    K, S = seg.shape
    B = addr.shape[1] if addr.dim() == 2 else -1
    for t, name in ((addr, "addr"), (nwords, "nwords")):
        _check(t, name, (K, B), torch.int32, seg.device)
    out = torch.empty((K, B, W), dtype=seg.dtype, device=seg.device)
    if B == 0 or W == 0:
        return out
    lib = _lib()
    status = lib.datamover_gather(
        seg.data_ptr(), K, S, addr.data_ptr(), nwords.data_ptr(), B, W,
        out.data_ptr(), _DTYPES[seg.dtype],
        torch.cuda.current_stream(seg.device).cuda_stream)
    _check_status(lib, status, "datamover_gather")
    datamover_gather_cuda.launches += 1
    return out


def datamover_scatter_cuda(seg: torch.Tensor, pay: torch.Tensor,
                           addr: torch.Tensor, nwords: torch.Tensor,
                           handler: torch.Tensor,
                           active: torch.Tensor) -> torch.Tensor:
    """Kernel version of :func:`..ref.datamover_scatter_ref` with the
    built-in handlers; updates ``seg`` in place and returns it."""
    _check_seg(seg)
    K, S = seg.shape
    if pay.dim() != 3:
        raise ValueError(f"pay must be (K, B, W), got {tuple(pay.shape)}")
    B, W = pay.shape[1], pay.shape[2]
    _check(pay, "pay", (K, B, W), seg.dtype, seg.device)
    for t, name in ((addr, "addr"), (nwords, "nwords"),
                    (handler, "handler"), (active, "active")):
        _check(t, name, (K, B), torch.int32, seg.device)
    if B == 0 or W == 0:
        return seg
    lib = _lib()
    status = lib.datamover_scatter(
        seg.data_ptr(), K, S, pay.data_ptr(), addr.data_ptr(),
        nwords.data_ptr(), handler.data_ptr(), active.data_ptr(), B, W,
        _DTYPES[seg.dtype], torch.cuda.current_stream(seg.device).cuda_stream)
    _check_status(lib, status, "datamover_scatter")
    datamover_scatter_cuda.launches += 1
    return seg


datamover_gather_cuda.launches = 0
datamover_scatter_cuda.launches = 0
