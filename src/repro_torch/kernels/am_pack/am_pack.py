"""ctypes bindings of the two DataMover designs.

* ``csrc/am_pack_sm90.cu`` (``"sm90"``): the Hopper design -- a gather
  whose lanes are tiled over enough CTAs to fill the card, every load in
  flight before any store, 16-byte vectors where a row allows; a scatter
  on the same grid that applies every word one block alone touches at
  once and has the first block that touches a shared word fold every
  later block's lane on it in block order.  float32, int32, bfloat16 and
  float16 words.
* ``csrc/am_pack.cu`` (``"simple"``): the first design, one CTA per
  packet row (gather) or per kernel row walking its blocks in order
  (scatter); float32 and int32 words.

:func:`datamover_kernel_for` decides between them from the shape and
the word type alone, before the launch; nothing is retried.
:func:`datamover_plan` picks the Hopper design's tile.  The wrappers
take CUDA tensors only, check them, launch on PyTorch's current stream
and raise if the launch fails.  Each kernel counts its own launches in
a plain integer: ``launch_gather.launches`` and
``launch_scatter.launches`` (the simple design),
``launch_gather_sm90.launches`` and ``launch_scatter_sm90.launches``.
The libraries are built at first use (:mod:`repro_torch.kernels._build`).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.int32: 1}                 # simple design
_DTYPES_SM90 = {torch.float32: 0, torch.int32: 1, torch.bfloat16: 2,
                torch.float16: 3}
_P, _I = ctypes.c_void_p, ctypes.c_int
KERNELS = ("sm90", "simple")
GATHER, SCATTER = "gather", "scatter"
VEC_BYTES = 16              # one vector load or store
SM_COUNT = 132              # SMs of an H100 SXM: the grid the plan fills
THREADS = 128               # the CTA size the plan starts from
VT = 2                      # units (16-byte vectors) per thread it starts from
STAGE_MAX_B = 2048          # staged headers: 16 bytes a block in 48 KB
GRID_MAX = 65535            # the grid's y (B) and z (K) dimensions
# datamover_kernel_for's routes, from scripts/datamover_sweep.py
# (PERF.md): the shapes at which the Hopper design won both turns at
# every K (1, 8) and layout (disjoint, aliasing; ragged rows and gated
# duplicate rows at W 4, 8, 64 and 2250) measured, with a measured
# point on each side of each bound.  Below them the simple
# design won by 0-10 % (a narrow row is one launch and two dependent
# loads in either, and the Hopper kernels spend more instructions on
# each); the staged scatter won at every B measured, up to STAGE_MAX_B.
GATHER_MIN_W = 1536         # gathers of rows this wide or wider,
GATHER_MANY = (1024, 320)   # or this wide, of this many rows (K * B)
SCATTER_MIN_B = 4           # scatters of this many blocks per row or more,
SCATTER_MIN_W = {1: 1536, 2: 1024, 3: 1024}   # or of fewer, this wide,
SCATTER_FEW = 2             # or of at most this many rows (K * B)


class Plan(NamedTuple):
    """The Hopper design's launch: ``threads`` per CTA, ``vt`` units of
    16 bytes per thread, ``tiles`` CTAs per packet row, ``ctas`` in all,
    and for the scatter whether it ``walk``s every block in order (one
    CTA per kernel row) instead of staging the headers.  A scatter CTA
    has a unit for every V threads (``vt`` 1): V lanes a thread where
    its block meets no other, one where it does."""
    threads: int
    vt: int
    tiles: int
    ctas: int
    walk: bool


def _sm90_dtype(dtype: torch.dtype) -> None:
    if dtype not in _DTYPES_SM90:
        raise TypeError(f"DataMover kernels move float32, int32, bfloat16 "
                        f"and float16 words, got {dtype}")


def datamover_plan(op: str, K: int, B: int, W: int,
                   dtype: torch.dtype) -> Plan:
    """The Hopper design's tile for ``K`` kernel rows of ``B`` packet rows
    of ``W`` lanes.  A unit is V = 16 / word bytes lanes; a row has
    ``ceil(W / V) + 1`` of them (its ragged head first).  The gather's
    CTA starts at 128 threads of 2 units, the scatter's at 128 units of
    V threads; the CTA shrinks to the row (units per thread, then
    threads or units, down to a warp), then halves until the grid holds
    at least ``SM_COUNT`` CTAs or a CTA is one warp.  The scatter walks
    its blocks in order above ``STAGE_MAX_B`` blocks: one CTA per kernel
    row, up to 1024 threads.  Raises ``TypeError`` for a word type it does not
    move."""
    if op not in (GATHER, SCATTER):
        raise ValueError(f"op must be {GATHER!r} or {SCATTER!r}, got {op!r}")
    _sm90_dtype(dtype)
    if min(K, B, W) < 1:
        raise ValueError(f"empty DataMover call: K={K} B={B} W={W}")
    V = VEC_BYTES // dtype.itemsize
    units = -(-W // V) + 1
    if op == SCATTER and B > STAGE_MAX_B:
        # one CTA per kernel row, a thread per lane
        return Plan(min(1024, 32 * -(-W // 32)), 1, 1, K, True)
    if max(K, B) > GRID_MAX:
        raise ValueError(f"the Hopper DataMover's grid (tiles, B, K) holds "
                         f"B and K up to {GRID_MAX}; K={K} B={B} do not fit")
    # threads (gather) or units (scatter) per CTA, and units per thread
    t, vt = THREADS, (VT if op == GATHER else 1)
    t_min = 32 if op == GATHER else 32 // V
    while vt > 1 and t * (vt // 2) >= units:
        vt //= 2
    while t > t_min and t // 2 * vt >= units:
        t //= 2

    def tiles():
        return -(-units // (t * vt))

    while K * B * tiles() < SM_COUNT and (vt > 1 or t > t_min):
        if vt > 1:
            vt //= 2
        else:
            t //= 2
    threads = t if op == GATHER else t * V
    return Plan(threads, vt, tiles(), K * B * tiles(), False)


def datamover_kernel_for(op: str, K: int, B: int, W: int,
                         dtype: torch.dtype) -> str:
    """``"sm90"`` for 16-bit words whatever the shape (only the Hopper
    design moves them), and for 32-bit words where
    scripts/datamover_sweep.py measured it faster: gathers of rows of at
    least ``GATHER_MIN_W`` lanes, or of ``GATHER_MANY[0]`` lanes in at
    least ``GATHER_MANY[1]`` rows (up to ``GRID_MAX`` rows per kernel
    row); scatters of ``SCATTER_MIN_B`` to ``STAGE_MAX_B`` blocks per
    kernel row, or of fewer blocks of rows of at least
    ``SCATTER_MIN_W[B]`` lanes or in at most ``SCATTER_FEW`` rows.  Else
    ``"simple"``.  A pure function of its arguments, decided before the
    launch."""
    if op not in (GATHER, SCATTER):
        raise ValueError(f"op must be {GATHER!r} or {SCATTER!r}, got {op!r}")
    if dtype in (torch.bfloat16, torch.float16):
        return "sm90"
    if op == GATHER:
        wins = B <= GRID_MAX and (W >= GATHER_MIN_W or (
            W >= GATHER_MANY[0] and K * B >= GATHER_MANY[1]))
    else:
        wins = B <= STAGE_MAX_B and (B >= SCATTER_MIN_B or K * B
                                     <= SCATTER_FEW or W >= SCATTER_MIN_W[B])
    return "sm90" if wins else "simple"


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


def _lib_sm90():
    lib = _build.load("am_pack_sm90")
    if not getattr(lib, "_typed", False):
        lib.datamover_gather_sm90.argtypes = [_P, _I, _I, _P, _P, _I, _I, _P,
                                              _I, _I, _I, _I, _I, _P]
        lib.datamover_gather_sm90.restype = _I
        lib.datamover_scatter_sm90.argtypes = [_P, _I, _I, _P, _P, _P, _P,
                                               _P, _I, _I, _I, _I, _I, _I, _I,
                                               _P]
        lib.datamover_scatter_sm90.restype = _I
        lib.datamover_empty_sm90.argtypes = [_P]
        lib.datamover_empty_sm90.restype = _I
        lib.datamover_sm90_error_string.argtypes = [_I]
        lib.datamover_sm90_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check_status(status: int, what: str, errstr) -> None:
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} "
                           f"({errstr(status).decode()})")


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
    _sm90_dtype(seg.dtype)


def _route(op: str, seg: torch.Tensor, B: int, W: int,
           kernel: str | None) -> str:
    """:func:`datamover_kernel_for`'s choice, or the forced ``kernel``;
    ``"simple"`` raises on a word type the simple design does not
    move."""
    if kernel is None:
        kernel = datamover_kernel_for(op, seg.shape[0], B, W, seg.dtype)
    if kernel not in KERNELS:
        raise ValueError(f"kernel must be one of {KERNELS}, got {kernel!r}")
    if kernel == "simple" and seg.dtype not in _DTYPES:
        raise TypeError(f"the simple DataMover kernels (csrc/am_pack.cu) "
                        f"move float32/int32 words, got {seg.dtype}")
    return kernel


def _aligned(*ts: torch.Tensor) -> bool:
    return all(t.data_ptr() % VEC_BYTES == 0 for t in ts)


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def launch_gather(seg, addr, nwords, W, out) -> None:
    """The simple gather on checked inputs."""
    K, S = seg.shape
    lib = _lib()
    status = lib.datamover_gather(
        seg.data_ptr(), K, S, addr.data_ptr(), nwords.data_ptr(),
        addr.shape[1], W, out.data_ptr(), _DTYPES[seg.dtype], _stream(seg))
    _check_status(status, "datamover_gather", lib.datamover_error_string)
    launch_gather.launches += 1


def launch_gather_sm90(seg, addr, nwords, W, out, plan: Plan) -> None:
    """The Hopper gather on checked inputs, at ``plan``."""
    K, S = seg.shape
    lib = _lib_sm90()
    status = lib.datamover_gather_sm90(
        seg.data_ptr(), K, S, addr.data_ptr(), nwords.data_ptr(),
        addr.shape[1], W, out.data_ptr(), _DTYPES_SM90[seg.dtype],
        plan.threads, plan.vt, plan.tiles, int(_aligned(seg, out)),
        _stream(seg))
    _check_status(status, "datamover_gather_sm90",
                  lib.datamover_sm90_error_string)
    launch_gather_sm90.launches += 1


def launch_scatter(seg, pay, addr, nwords, handler, active) -> None:
    """The simple scatter on checked inputs."""
    K, S = seg.shape
    lib = _lib()
    status = lib.datamover_scatter(
        seg.data_ptr(), K, S, pay.data_ptr(), addr.data_ptr(),
        nwords.data_ptr(), handler.data_ptr(), active.data_ptr(),
        pay.shape[1], pay.shape[2], _DTYPES[seg.dtype], _stream(seg))
    _check_status(status, "datamover_scatter", lib.datamover_error_string)
    launch_scatter.launches += 1


def launch_scatter_sm90(seg, pay, addr, nwords, handler, active,
                        plan: Plan) -> None:
    """The Hopper scatter on checked inputs, at ``plan``."""
    K, S = seg.shape
    lib = _lib_sm90()
    status = lib.datamover_scatter_sm90(
        seg.data_ptr(), K, S, pay.data_ptr(), addr.data_ptr(),
        nwords.data_ptr(), handler.data_ptr(), active.data_ptr(),
        pay.shape[1], pay.shape[2], _DTYPES_SM90[seg.dtype], plan.threads,
        plan.tiles, int(plan.walk), int(_aligned(seg, pay)), _stream(seg))
    _check_status(status, "datamover_scatter_sm90",
                  lib.datamover_sm90_error_string)
    launch_scatter_sm90.launches += 1


def launch_empty_sm90(device: torch.device) -> None:
    """One empty CTA on ``device``'s current stream: the launch floor a
    DataMover kernel's time is read against (not a kernel of any path,
    and counted nowhere)."""
    lib = _lib_sm90()
    status = lib.datamover_empty_sm90(
        torch.cuda.current_stream(device).cuda_stream)
    _check_status(status, "datamover_empty_sm90",
                  lib.datamover_sm90_error_string)


def datamover_gather_cuda(seg: torch.Tensor, addr: torch.Tensor,
                          nwords: torch.Tensor, W: int,
                          kernel: str | None = None) -> torch.Tensor:
    """Kernel version of :func:`..ref.datamover_gather_ref`.  The kernel
    is :func:`datamover_kernel_for`'s choice; ``kernel="simple"`` or
    ``"sm90"`` forces one (for comparisons: nothing on the main path
    sets it)."""
    _check_seg(seg)
    K, S = seg.shape
    B = addr.shape[1] if addr.dim() == 2 else -1
    for t, name in ((addr, "addr"), (nwords, "nwords")):
        _check(t, name, (K, B), torch.int32, seg.device)
    out = torch.empty((K, B, W), dtype=seg.dtype, device=seg.device)
    if B == 0 or W == 0:
        return out
    if _route(GATHER, seg, B, W, kernel) == "sm90":
        launch_gather_sm90(seg, addr, nwords, W, out,
                           datamover_plan(GATHER, K, B, W, seg.dtype))
    else:
        launch_gather(seg, addr, nwords, W, out)
    return out


def datamover_scatter_cuda(seg: torch.Tensor, pay: torch.Tensor,
                           addr: torch.Tensor, nwords: torch.Tensor,
                           handler: torch.Tensor, active: torch.Tensor,
                           kernel: str | None = None) -> torch.Tensor:
    """Kernel version of :func:`..ref.datamover_scatter_ref` with the
    built-in handlers; updates ``seg`` in place and returns it.
    ``kernel`` as for :func:`datamover_gather_cuda`."""
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
    if _route(SCATTER, seg, B, W, kernel) == "sm90":
        launch_scatter_sm90(seg, pay, addr, nwords, handler, active,
                            datamover_plan(SCATTER, K, B, W, seg.dtype))
    else:
        launch_scatter(seg, pay, addr, nwords, handler, active)
    return seg


launch_gather.launches = 0
launch_scatter.launches = 0
launch_gather_sm90.launches = 0
launch_scatter_sm90.launches = 0
