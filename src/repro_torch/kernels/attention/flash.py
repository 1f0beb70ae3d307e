"""ctypes bindings of the three flash-attention kernels, causal or not.

* ``csrc/flash_sm90.cu`` (``flash_attention_sm90_fwd``): the Hopper
  kernel -- TMA tile ring, ``wgmma`` on the tensor cores -- for bfloat16
  q, k, v laid out on TMA's 16-byte grid: every equal head dim whose row
  is on that grid (a multiple of 8, up to 256), run in the smallest of
  its tiles ``SM90_TILES`` that holds it (zero columns past the head
  dim), and MLA's q·k 192 / v 128.
* ``csrc/flash_sm90_f32.cu`` (``flash_attention_sm90_f32_fwd``): the
  Hopper kernel for float32 -- TMA tile ring, TF32 ``mma.sync`` on the
  tensor cores -- on the same grid: equal head dims that are multiples
  of 4 up to 256 (tiles ``SM90_F32_TILES``) and MLA's pair.
* ``csrc/flash.cu`` (``flash_attention_fwd``): the simple kernel --
  float32 FMAs, any strides -- for what TMA cannot describe, in either
  type: a head dim that is not contiguous, a zero or off-grid stride
  (an expanded kv head), a misaligned pointer, a head-dim row that is
  not a multiple of 16 bytes (bfloat16 dh 100, float32 dh 30).  Every
  head dim the Hopper kernels take beat it in one chip call
  (``scripts/flash_pad_sweep.py``), so none is kept on it.
  ``kernel="simple"`` forces it: the exact float32 yardstick.

:func:`flash_kernel_for` decides between them from shapes, strides,
dtype and alignment alone, before the launch; nothing is retried.
:func:`flash_attention_cuda` takes CUDA tensors only, checks them,
allocates the output, launches the chosen kernel on PyTorch's current
stream and raises if the launch fails.  All three take ``causal`` and a
key length ``T`` of its own (``T == S`` when causal; any ``T >= 1``
without: cross-attention's prompt pass over the image tokens).
Launches are counted on ``flash_attention_cuda.launches`` (any kernel),
on ``launch_flash_sm90.launches`` and ``launch_flash_sm90_f32.launches``
(each Hopper kernel alone) and on ``noncausal_launches.launches`` (any
kernel with ``causal`` off).

The training route (:func:`train_kernel_for`): causal bfloat16 GQA at
head dims ``BWD_HEAD_DIMS`` on the same grid, differentiable through
``ops.flash_attention_train``.  Its forward is ``flash_sm90.cu``'s
kernel with the log-sum-exp flag on (``flash_attention_sm90_fwd_lse``,
:func:`flash_attention_lse_cuda`, counted on
``launch_flash_sm90_lse.launches``), its backward
``csrc/flash_sm90_bwd.cu`` (``flash_attention_sm90_bwd``: D, then dK /
dV and dQ by ``wgmma``; :func:`flash_attention_bwd_cuda`, counted on
``launch_flash_sm90_bwd.launches``, one a backward).
"""

from __future__ import annotations

import ctypes
import types

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_DH = 256                # largest head dim any kernel holds
MLA_HEAD_DIMS = (192, 128)  # the one (q·k, v) pair of unequal head dims
# the square tiles each Hopper kernel is instantiated at (beside MLA's
# (192, 128)); an equal head dim runs in the smallest that holds it
SM90_TILES = (16, 32, 64, 128, 256)     # flash_sm90.cu's MIN_TILE 16
SM90_F32_TILES = (32, 64, 128, 256)     # flash_sm90_f32.cu's SMALL_TILE 32
# the equal head dims the training route's backward is instantiated at
BWD_HEAD_DIMS = (64, 128)
TMA_ALIGN = 16              # bytes: TMA's base-address and stride grid
MAX_GRID_YZ = 65535         # heads (grid y) and batch (grid z)
KERNELS = ("sm90", "sm90_f32", "simple")
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
        lib.flash_attention_sm90_fwd_lse.argtypes = [
            _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _Strides, _Strides,
            _Strides, _P]
        lib.flash_attention_sm90_fwd_lse.restype = _I
        lib.flash_sm90_error_string.argtypes = [_I]
        lib.flash_sm90_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


# the Hopper kernel of each type, its tiles, and the head dims whose row
# is a multiple of 16 bytes: multiples of 8 (bfloat16) or 4 (float32)
_SM90 = {torch.bfloat16: ("sm90", SM90_TILES, 8),
         torch.float32: ("sm90_f32", SM90_F32_TILES, 4)}


def sm90_head_dims(dtype: torch.dtype, dqk: int, dv: int) -> bool:
    """Whether the Hopper kernel of ``dtype`` takes head dims ``(dqk,
    dv)``: MLA's (192, 128), or equal ones up to ``MAX_DH`` whose row is
    a multiple of 16 bytes (bfloat16: of 8; float32: of 4)."""
    if dtype not in _SM90:
        return False
    if (dqk, dv) == MLA_HEAD_DIMS:
        return True
    return dqk == dv and 0 < dqk <= MAX_DH and dqk % _SM90[dtype][2] == 0


def sm90_tile(dtype: torch.dtype, dqk: int, dv: int) -> tuple[int, int]:
    """The ``(q·k, v)`` tile the Hopper kernel of ``dtype`` runs head
    dims ``(dqk, dv)`` in (those :func:`sm90_head_dims` takes): MLA's
    pair as it is, an equal head dim in the smallest square tile that
    holds it, its columns past the head dim zeros."""
    if (dqk, dv) == MLA_HEAD_DIMS:
        return MLA_HEAD_DIMS
    tile = next(t for t in _SM90[dtype][1] if t >= dqk)
    return tile, tile


def flash_kernel_for(q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> str:
    """``"sm90"`` or ``"sm90_f32"`` when a Hopper kernel takes these
    inputs, else ``"simple"``.  A pure function of dtype, shapes,
    strides and the pointers' alignment: q, k and v of one type --
    bfloat16 (the ``wgmma`` kernel) or float32 (the TF32 kernel) -- at
    head dims :func:`sm90_head_dims` admits (MLA's (192, 128), or equal
    ones whose row is a multiple of 16 bytes up to 256), with the head
    dim contiguous, every other stride a positive multiple of 16 bytes
    and every pointer 16-byte aligned (what a TMA tensor map takes).
    Everything else goes to the simple kernel.
    Causal or not, and the key length, do not enter the choice."""
    if not q.dtype == k.dtype == v.dtype or q.dtype not in _SM90:
        return "simple"
    route = _SM90[q.dtype][0]
    if not sm90_head_dims(q.dtype, q.shape[-1], v.shape[-1]):
        return "simple"
    for t in (q, k, v):
        *outer, inner = t.stride()
        if inner != 1 or t.data_ptr() % TMA_ALIGN:
            return "simple"
        if any(s <= 0 or s * t.element_size() % TMA_ALIGN for s in outer):
            return "simple"
    return route


def sm90_train_takes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     window: int = 0) -> bool:
    """Whether the training route's kernels take causal self-attention
    over these q, k, v, wherever they lie: q ``(B, S, H, dh)`` over k
    and v of its own length, ``H % K == 0``, no key masked by the window
    (``window`` 0 or ``S <= window``), bfloat16, equal head dims of
    ``BWD_HEAD_DIMS``, on TMA's grid as :func:`flash_kernel_for` takes
    them.  A pure function of shapes, strides, dtype and alignment."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        return False
    S, H, dh = q.shape[1:]
    if k.shape[1] != S or v.shape[:3] != k.shape[:3] or H % k.shape[2]:
        return False
    if window and S > window:
        return False
    if v.shape[-1] != dh or dh not in BWD_HEAD_DIMS or k.shape[-1] != dh:
        return False
    return q.dtype == torch.bfloat16 and flash_kernel_for(q, k, v) == "sm90"


def train_kernel_for(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     window: int = 0) -> str:
    """``"sm90"`` when a differentiable causal attention over these
    inputs runs on the training route's kernels: CUDA tensors that
    :func:`sm90_train_takes`; else ``"plain"`` (the CPU, float32, other
    head dims, views TMA cannot describe, a window that masks).  A pure
    function of device, shapes, strides, dtype and alignment."""
    if q.device.type == "cuda" and sm90_train_takes(q, k, v, window=window):
        return "sm90"
    return "plain"


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


def _lib_sm90_f32():
    lib = _build.load("flash_sm90_f32")
    if not getattr(lib, "_typed", False):
        lib.flash_attention_sm90_f32_fwd.argtypes = [
            _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _Strides, _Strides,
            _Strides, _I, _P]
        lib.flash_attention_sm90_f32_fwd.restype = _I
        lib.flash_sm90_f32_error_string.argtypes = [_I]
        lib.flash_sm90_f32_error_string.restype = ctypes.c_char_p
        lib.flash_sm90_f32_precision.restype = _I
        lib._typed = True
    return lib


def f32_precision() -> int:
    """The routed float32 build's ``PRECISION``: 0, one TF32 pass on
    both products; 1, QKᵀ split into three; 2, both split."""
    return int(_lib_sm90_f32().flash_sm90_f32_precision())


def launch_flash_sm90_f32(q, k, v, out, causal=True) -> None:
    """Launch the float32 Hopper kernel on checked inputs it takes;
    raises if the launch fails."""
    lib = _lib_sm90_f32()
    dims, strides = _args(q, k, v, out)
    status = lib.flash_attention_sm90_f32_fwd(
        *dims, v.shape[-1], *strides, int(causal),
        torch.cuda.current_stream(q.device).cuda_stream)
    if status != 0:
        raise RuntimeError(
            f"flash_attention_sm90_f32_fwd: error {status} "
            f"({lib.flash_sm90_f32_error_string(status).decode()})")
    launch_flash_sm90_f32.launches += 1


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
    ``kernel="sm90"`` / ``"sm90_f32"`` raises on inputs that Hopper
    kernel does not take."""
    _check(q, k, v, causal)
    route = flash_kernel_for(q, k, v)
    if kernel is not None:
        if kernel not in KERNELS:
            raise ValueError(f"kernel must be one of {KERNELS}, got "
                             f"{kernel!r}")
        if kernel != "simple" and route != kernel:
            raise ValueError(f"the {kernel} kernel does not take these "
                             f"inputs (see flash_kernel_for)")
        route = kernel
    out = torch.empty(q.shape[:-1] + v.shape[-1:], dtype=q.dtype,
                      device=q.device)
    if out.numel() == 0:
        return out
    if route == "sm90":
        launch_flash_sm90(q, k, v, out, causal)
    elif route == "sm90_f32":
        launch_flash_sm90_f32(q, k, v, out, causal)
    else:
        _launch_simple(q, k, v, out, causal)
    flash_attention_cuda.launches += 1
    if not causal:
        noncausal_launches.launches += 1
    return out


def _lib_sm90_bwd():
    lib = _build.load("flash_sm90_bwd")
    if not getattr(lib, "_typed", False):
        lib.flash_attention_sm90_bwd.argtypes = [
            _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
            _Strides, _Strides, _Strides, _Strides, _P]
        lib.flash_attention_sm90_bwd.restype = _I
        lib.flash_sm90_bwd_error_string.argtypes = [_I]
        lib.flash_sm90_bwd_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check_train(*ts):
    q = ts[0]
    for t in ts:
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError("the training route's kernels take CUDA "
                             "tensors on one device")
    if train_kernel_for(*ts[:3]) != "sm90":
        raise ValueError("the training route's kernels do not take these "
                         "inputs (see train_kernel_for)")


def launch_flash_sm90_lse(q, k, v, out, lse) -> None:
    """Launch the causal Hopper forward with the log-sum-exp flag on:
    ``out (B, S, H, dh)`` and ``lse (B, H, S)`` float32, both
    contiguous; raises if the launch fails."""
    lib = _lib_sm90()
    B, S, H, dh = q.shape
    status = lib.flash_attention_sm90_fwd_lse(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), B, S, H, k.shape[2], dh, _Strides(*q.stride()),
        _Strides(*k.stride()), _Strides(*v.stride()),
        torch.cuda.current_stream(q.device).cuda_stream)
    if status != 0:
        raise RuntimeError(f"flash_attention_sm90_fwd_lse: error {status} "
                           f"({lib.flash_sm90_error_string(status).decode()})")
    launch_flash_sm90_lse.launches += 1


def launch_flash_sm90_bwd(q, k, v, out, dout, lse, dq, dk, dv) -> None:
    """Launch the Hopper backward (D, dK / dV, dQ) on checked inputs;
    ``dout`` and the gradients contiguous; raises if a launch fails."""
    lib = _lib_sm90_bwd()
    B, S, H, dh = q.shape
    dsum = torch.empty_like(lse)
    status = lib.flash_attention_sm90_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, S, H, k.shape[2], dh,
        _Strides(*q.stride()), _Strides(*k.stride()), _Strides(*v.stride()),
        _Strides(*dout.stride()),
        torch.cuda.current_stream(q.device).cuda_stream)
    if status != 0:
        raise RuntimeError(
            f"flash_attention_sm90_bwd: error {status} "
            f"({lib.flash_sm90_bwd_error_string(status).decode()})")
    launch_flash_sm90_bwd.launches += 1


def flash_attention_lse_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor):
    """Causal attention on the training route's forward: ``q (B, S, H,
    dh)``, ``k`` and ``v (B, S, K, dh)`` that :func:`train_kernel_for`
    sends to ``"sm90"`` -> ``(out (B, S, H, dh), lse (B, H, S))``, lse
    the float32 log-sum-exp of each query row's scaled scores."""
    _check_train(q, k, v)
    B, S, H, dh = q.shape
    out = torch.empty(B, S, H, dh, dtype=q.dtype, device=q.device)
    lse = torch.empty(B, H, S, dtype=torch.float32, device=q.device)
    launch_flash_sm90_lse(q, k, v, out, lse)
    return out, lse


def flash_attention_bwd_cuda(q, k, v, out, lse, dout):
    """The gradients ``(dq, dk, dv)`` of :func:`flash_attention_lse_cuda`'s
    output at ``dout (B, S, H, dh)``, given its ``out`` and ``lse``."""
    _check_train(q, k, v, out, lse, dout)
    dout = dout.contiguous()
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    launch_flash_sm90_bwd(q, k, v, out.contiguous(), dout, lse, dq, dk, dv)
    return dq, dk, dv


flash_attention_cuda.launches = 0
launch_flash_sm90.launches = 0
launch_flash_sm90_lse.launches = 0
launch_flash_sm90_bwd.launches = 0
launch_flash_sm90_f32.launches = 0
# launches of either kernel with causal=False
noncausal_launches = types.SimpleNamespace(launches=0)
