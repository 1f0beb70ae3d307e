"""ctypes binding of the causal flash-attention kernel in ``csrc/flash.cu``.

:func:`flash_attention_cuda` takes CUDA tensors only, checks them, reads
every stride of q, k and v (no view is made contiguous), allocates the
output, launches on PyTorch's current stream, raises if the launch
fails, and counts its launches in ``flash_attention_cuda.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_DH = 128                # largest head dim the kernel holds
MAX_GRID_YZ = 65535         # heads (grid y) and batch (grid z)
_P, _I = ctypes.c_void_p, ctypes.c_int
_Strides = ctypes.c_longlong * 4


def _lib():
    lib = _build.load("flash")
    if not getattr(lib, "_typed", False):
        lib.flash_attention_fwd.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I,
                                            _I, _Strides, _Strides, _Strides,
                                            _I, _P]
        lib.flash_attention_fwd.restype = _I
        lib.flash_error_string.argtypes = [_I]
        lib.flash_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor) -> torch.Tensor:
    """Causal attention by index on the card: ``q (B, S, H, dh)``,
    ``k, v (B, S, K, dh)`` with ``H % K == 0`` and ``dh <= 128``, float32
    or bfloat16 -> a new contiguous ``(B, S, H, dh)``."""
    for t in (q, k, v):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"flash_attention_cuda takes CUDA tensors on "
                             f"one device, got {q.device}, {k.device}, "
                             f"{v.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash kernel takes float32/bfloat16 q, k, v of "
                        f"one type, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be (B, S, H, dh) and k, v (B, S, K, dh), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, H, dh = q.shape
    K = k.shape[2]
    if (k.shape[0], k.shape[1], k.shape[3]) != (B, S, dh) or K < 1 \
            or H % K:
        raise ValueError(f"k, v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)}: need (B, S, K, dh) with H % K "
                         f"== 0")
    if not 1 <= dh <= MAX_DH:
        raise ValueError(f"head dim {dh} outside the kernel's 1..{MAX_DH}")
    if H > MAX_GRID_YZ or B > MAX_GRID_YZ:
        raise ValueError(f"{B} sequences x {H} heads exceed the grid")
    out = torch.empty((B, S, H, dh), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    status = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, H,
        K, dh, _Strides(*q.stride()), _Strides(*k.stride()),
        _Strides(*v.stride()), _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if status != 0:
        raise RuntimeError(f"flash_attention_fwd: CUDA error {status} "
                           f"({lib.flash_error_string(status).decode()})")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
