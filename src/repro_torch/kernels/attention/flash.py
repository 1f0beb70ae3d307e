"""ctypes bindings of the two flash-attention kernels, causal or not.

* ``csrc/flash_sm90.cu`` (``flash_attention_sm90_fwd``): the Hopper
  kernel -- TMA tile ring, ``wgmma`` on the tensor cores -- for bfloat16
  q, k, v laid out on TMA's 16-byte grid at the (q·k, v) head dims of
  ``SM90_HEAD_DIMS``: 64, 128, MLA's 192 / 128 and recurrentgemma's 256.
* ``csrc/flash.cu`` (``flash_attention_fwd``): the simple kernel --
  float32 FMAs, any strides -- for everything else it holds (float32,
  other head dims up to 256, views whose head dim is not contiguous or
  whose strides or pointers are off TMA's grid).

:func:`flash_kernel_for` decides between them from shapes, strides,
dtype and alignment alone, before the launch; nothing is retried.
:func:`flash_attention_cuda` takes CUDA tensors only, checks them,
allocates the output, launches the chosen kernel on PyTorch's current
stream and raises if the launch fails.  Both kernels take ``causal`` and
a key length ``T`` of its own (``T == S`` when causal; any ``T >= 1``
without: cross-attention's prompt pass over the image tokens).
Launches are counted on ``flash_attention_cuda.launches`` (either
kernel), on ``launch_flash_sm90.launches`` (the Hopper kernel alone) and
on ``noncausal_launches.launches`` (either kernel with ``causal`` off).
"""

from __future__ import annotations

import ctypes
import types

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_DH = 256                # largest head dim the simple kernel holds
MLA_HEAD_DIMS = (192, 128)  # the one (q·k, v) pair of unequal head dims
# (q·k, v) head dims the Hopper kernel holds
SM90_HEAD_DIMS = ((64, 64), (128, 128), MLA_HEAD_DIMS, (256, 256))
TMA_ALIGN = 16              # bytes: TMA's base-address and stride grid
MAX_GRID_YZ = 65535         # heads (grid y) and batch (grid z)
KERNELS = ("sm90", "simple")
_P, _I = ctypes.c_void_p, ctypes.c_int
_Strides = ctypes.c_longlong * 4


def _lib():
    lib = _build.load("flash")
    if not getattr(lib, "_typed", False):
        lib.flash_attention_fwd.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I,
                                            _I, _I, _I, _Strides, _Strides,
                                            _Strides, _I, _I, _P]
        lib.flash_attention_fwd.restype = _I
        lib.flash_error_string.argtypes = [_I]
        lib.flash_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _lib_sm90():
    lib = _build.load("flash_sm90")
    if not getattr(lib, "_typed", False):
        lib.flash_attention_sm90_fwd.argtypes = [_P, _P, _P, _P, _I, _I, _I,
                                                 _I, _I, _I, _I, _Strides,
                                                 _Strides, _Strides, _I, _P]
        lib.flash_attention_sm90_fwd.restype = _I
        lib.flash_sm90_error_string.argtypes = [_I]
        lib.flash_sm90_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def flash_kernel_for(q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> str:
    """``"sm90"`` when the Hopper kernel takes these inputs, else
    ``"simple"``.  A pure function of dtype, shapes, strides and the
    pointers' alignment: bfloat16 q, k and v whose (q·k, v) head dims
    are one of ``SM90_HEAD_DIMS`` -- (64, 64), (128, 128), MLA's (192,
    128), (256, 256) -- the head dim contiguous, every other stride a
    positive multiple of 16 bytes and every pointer 16-byte aligned (what
    a TMA tensor map takes).  Float32, other head dims and inputs off
    that grid go to the simple kernel.
    Causal or not, and the key length, do not enter the choice."""
    if not q.dtype == k.dtype == v.dtype == torch.bfloat16:
        return "simple"
    if (q.shape[-1], v.shape[-1]) not in SM90_HEAD_DIMS:
        return "simple"
    for t in (q, k, v):
        *outer, inner = t.stride()
        if inner != 1 or t.data_ptr() % TMA_ALIGN:
            return "simple"
        if any(s <= 0 or s * t.element_size() % TMA_ALIGN for s in outer):
            return "simple"
    return "sm90"


def check_shapes(q_shape, k_shape, v_shape, causal: bool = True) -> None:
    """Raise ``ValueError`` unless the kernels take these shapes: ``q (B,
    S, H, dh)``, ``k (B, T, K, dh)``, ``v (B, T, K, dv)`` with ``H % K
    == 0``, ``T == S`` when ``causal`` and ``T >= 1`` when not, and
    either ``dv == dh <= 256`` or ``(dh, dv) == (192, 128)`` (MLA).  A
    pure function of the shapes."""
    if len(q_shape) != 4 or len(k_shape) != 4 or len(v_shape) != 4 \
            or tuple(k_shape[:3]) != tuple(v_shape[:3]):
        raise ValueError(f"q must be (B, S, H, dh), k (B, T, K, dh) and v "
                         f"(B, T, K, dv), got {tuple(q_shape)}, "
                         f"{tuple(k_shape)}, {tuple(v_shape)}")
    B, S, H, dh = q_shape
    T, K, dv = k_shape[1], k_shape[2], v_shape[3]
    if (k_shape[0], k_shape[3]) != (B, dh) or K < 1 or H % K:
        raise ValueError(f"k {tuple(k_shape)} does not fit q "
                         f"{tuple(q_shape)}: need (B, T, K, dh) with H % K "
                         f"== 0")
    if causal and T != S:
        raise ValueError(f"causal attention needs k and v of q's length "
                         f"S = {S}, got T = {T} (causal=False takes any T)")
    if not causal and T < 1:
        raise ValueError("attention over no key: T must be >= 1")
    if (dh, dv) != MLA_HEAD_DIMS and not (dh == dv and 1 <= dh <= MAX_DH):
        raise ValueError(f"head dim {dh} (q·k) / {dv} (v) outside the "
                         f"kernel's equal dims 1..{MAX_DH} and MLA's "
                         f"{MLA_HEAD_DIMS}")
    if H > MAX_GRID_YZ or B > MAX_GRID_YZ:
        raise ValueError(f"{B} sequences x {H} heads exceed the grid")


def _check(q, k, v, causal):
    for t in (q, k, v):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"flash_attention_cuda takes CUDA tensors on "
                             f"one device, got {q.device}, {k.device}, "
                             f"{v.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash kernel takes float32/bfloat16 q, k, v of "
                        f"one type, got {q.dtype}, {k.dtype}, {v.dtype}")
    check_shapes(q.shape, k.shape, v.shape, causal)


def _args(q, k, v, out):
    """The pointers and ``(B, S, T, H, K, dh)``; the strides."""
    B, S, H, dh = q.shape
    return ((q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S,
             k.shape[1], H, k.shape[2], dh),
            (_Strides(*q.stride()), _Strides(*k.stride()),
             _Strides(*v.stride())))


def launch_flash_sm90(q, k, v, out, causal=True) -> None:
    """Launch the Hopper kernel on checked inputs it takes; raises if the
    launch fails."""
    lib = _lib_sm90()
    dims, strides = _args(q, k, v, out)
    status = lib.flash_attention_sm90_fwd(
        *dims, v.shape[-1], *strides, int(causal),
        torch.cuda.current_stream(q.device).cuda_stream)
    if status != 0:
        raise RuntimeError(f"flash_attention_sm90_fwd: error {status} "
                           f"({lib.flash_sm90_error_string(status).decode()})")
    launch_flash_sm90.launches += 1


def _launch_simple(q, k, v, out, causal=True) -> None:
    """Launch the simple kernel on checked inputs; raises if the launch
    fails."""
    lib = _lib()
    dims, strides = _args(q, k, v, out)
    status = lib.flash_attention_fwd(
        *dims, v.shape[-1], *strides, int(causal), _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if status != 0:
        raise RuntimeError(f"flash_attention_fwd: CUDA error {status} "
                           f"({lib.flash_error_string(status).decode()})")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kernel: str | None = None, *,
                         causal: bool = True) -> torch.Tensor:
    """Attention by index on the card: ``q (B, S, H, dh)``, ``k (B, T, K,
    dh)``, ``v (B, T, K, dv)`` with ``H % K == 0``, ``T == S`` when
    ``causal`` (else any ``T >= 1``, every key valid), and ``dv == dh <=
    256`` or ``(dh, dv) == (192, 128)``, float32 or bfloat16 -> a new
    contiguous ``(B, S, H, dv)``.  The kernel is
    :func:`flash_kernel_for`'s choice; ``kernel="simple"`` forces the
    simple one (for comparisons: nothing on the main path sets it), and
    ``kernel="sm90"`` raises on inputs the Hopper kernel does not take."""
    _check(q, k, v, causal)
    route = flash_kernel_for(q, k, v)
    if kernel is not None:
        if kernel not in KERNELS:
            raise ValueError(f"kernel must be one of {KERNELS}, got "
                             f"{kernel!r}")
        if kernel == "sm90" and route != "sm90":
            raise ValueError("the sm90 kernel does not take these inputs "
                             "(see flash_kernel_for)")
        route = kernel
    out = torch.empty(q.shape[:-1] + v.shape[-1:], dtype=q.dtype,
                      device=q.device)
    if out.numel() == 0:
        return out
    if route == "sm90":
        launch_flash_sm90(q, k, v, out, causal)
    else:
        _launch_simple(q, k, v, out, causal)
    flash_attention_cuda.launches += 1
    if not causal:
        noncausal_launches.launches += 1
    return out


flash_attention_cuda.launches = 0
launch_flash_sm90.launches = 0
# launches of either kernel with causal=False
noncausal_launches = types.SimpleNamespace(launches=0)
