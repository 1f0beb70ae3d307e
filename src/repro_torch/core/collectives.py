"""Collectives built from one-sided Shoal puts (PyTorch port).

The paper positions AMs as the substrate on which higher communication
patterns are built (GASNet heritage: UPC/Chapel collectives sit on AM
puts/gets).  The ring algorithms here are ``put_long(handler=H_ADD)``
specialised to a neighbour ring: each step is one one-sided link
traversal carrying a payload that is combined at the receiver.  They
are the ``comm_backend="shoal"`` primitives of the data-parallel
trainer, which all-reduces every gradient leaf over its kernels.

Every function takes ``x`` stacked over the kernel axis, ``(K, ...)``,
with ``n = ctx.num_kernels = K``, and returns what the reference returns
on each kernel, stacked the same way.  The ring reduce-scatter,
all-gather and all-reduce run as one call of the ring kernel
(:mod:`repro_torch.kernels.gascore_dma`: one launch on a CUDA context,
its plain version on the CPU), and add one to ``ctx.exchanges`` for
every link traversal their schedule makes, as the reference's
``lax.ppermute`` steps would: ``n - 1`` for a reduce-scatter or an
all-gather, ``2(n - 1)`` for an all-reduce.  ``broadcast_from`` and
``all_to_all_vectored`` move data with the op layer's gather over the
kernel axis; ``tree_barrier`` is a reduction and no traversal.
"""

from __future__ import annotations

import torch

from repro_torch.core import ops
from repro_torch.core.state import ShoalContext
from repro_torch.kernels.gascore_dma import (ALL_GATHER, ALL_REDUCE,
                                             REDUCE_SCATTER, ring_collective)


def _ring_perm(n: int) -> list[tuple[int, int]]:
    return [(i, (i + 1) % n) for i in range(n)]


def _pad_to_chunks(x: torch.Tensor, n: int):
    """Every kernel's flat value zero-padded to ``n * chunk`` words,
    ``chunk = ceil(size / n)``: ``((K, n, chunk), pad)``."""
    flat = x.reshape(x.shape[0], -1)
    size = flat.shape[1]
    chunk = -(-size // n)
    pad = chunk * n - size
    if pad:
        flat = torch.cat([flat, flat.new_zeros(flat.shape[0], pad)], dim=1)
    return flat.reshape(x.shape[0], n, chunk).contiguous(), pad


def ring_reduce_scatter(ctx: ShoalContext, x: torch.Tensor) -> torch.Tensor:
    """Ring reduce-scatter of every kernel's full-size addend ``x (K,
    ...)``; returns ``(K, chunk)``, kernel ``k``'s reduced chunk ``k``
    (``chunk = ceil(size / n)``).  ``n - 1`` one-sided neighbour puts
    with the ADD handler."""
    n = ctx.num_kernels
    if n == 1:
        return x.reshape(1, -1)
    buf, _ = _pad_to_chunks(x, n)
    out = ring_collective(buf, REDUCE_SCATTER)
    ctx.exchanges += n - 1
    return out


def ring_all_gather(ctx: ShoalContext, chunk: torch.Tensor) -> torch.Tensor:
    """Ring all-gather: every kernel contributes ``chunk (K, ...)``;
    returns ``(K, n, c)``, every kernel holding all chunks in kernel
    order.  ``n - 1`` one-sided neighbour puts."""
    chunk = chunk.reshape(chunk.shape[0], -1)
    n = ctx.num_kernels
    if n == 1:
        return chunk[:, None]
    out = ring_collective(chunk.contiguous(), ALL_GATHER)
    ctx.exchanges += n - 1
    return out


def ring_all_reduce(ctx: ShoalContext, x: torch.Tensor) -> torch.Tensor:
    """Ring all-reduce = reduce-scatter + all-gather, one kernel launch
    (``2(n - 1)`` puts of ``size / n`` words each: bandwidth-optimal).
    Returns ``x.shape``, every kernel's row the sum over kernels."""
    n = ctx.num_kernels
    if n == 1:
        return x
    buf, pad = _pad_to_chunks(x, n)
    full = ring_collective(buf, ALL_REDUCE).reshape(x.shape[0], -1)
    ctx.exchanges += 2 * (n - 1)
    return full[:, :full.shape[1] - pad].reshape(x.shape)


def all_to_all_vectored(ctx: ShoalContext, x: torch.Tensor, *,
                        tiled: bool = True) -> torch.Tensor:
    """Vectored-AM all-to-all: kernel ``i``'s block ``j`` lands at kernel
    ``j`` slot ``i`` (the Shoal Vectored Long put over all kernel pairs,
    one exchange).  Each kernel's ``x[k]`` has a leading dimension of
    ``n`` blocks (``tiled=True``: a multiple of ``n``, cut into ``n``
    blocks; ``tiled=False``: exactly ``n`` one-row blocks), as
    ``lax.all_to_all(split_axis=0, concat_axis=0)`` takes it."""
    n = ctx.num_kernels
    m = x.shape[1]
    if (m % n if tiled else m != n):
        raise ValueError(f"all_to_all_vectored: leading dimension {m} of "
                         f"each kernel's value does not split into {n} "
                         f"blocks (tiled={tiled})")
    if n == 1:
        return x
    ctx.exchanges += 1
    blocks = x.reshape(n, n, m // n, *x.shape[2:])
    return blocks.transpose(0, 1).reshape(x.shape)


def tree_barrier(ctx: ShoalContext) -> torch.Tensor:
    """The dataflow barrier: a sum of one unit per kernel, ``(K,)`` int32
    all equal to ``n``.  A reduction, no link traversal (as
    :func:`repro_torch.core.ops.barrier`)."""
    return torch.full((ctx.num_kernels,), ctx.num_kernels, dtype=torch.int32,
                      device=ctx.device)


def broadcast_from(ctx: ShoalContext, x: torch.Tensor,
                   root: int = 0) -> torch.Tensor:
    """One-to-all: a ring pipeline of ``n - 1`` one-sided puts from
    ``root``.  Payloads may hold zeros, so a validity flag travels
    beside the buffer (a second exchange per step: ``2(n - 1)``)."""
    n = ctx.num_kernels
    if n == 1:
        return x
    per_kernel = (n,) + (1,) * (x.dim() - 1)
    root_k = ctx.my_id() == root
    buf = torch.where(root_k.reshape(per_kernel), x, torch.zeros_like(x))
    flag = root_k.to(x.dtype)
    perm = _ring_perm(n)
    for _ in range(n - 1):
        rb = ops._permute(ctx, perm, buf)
        rf = ops._permute(ctx, perm, flag)
        take = (rf > 0) & (flag == 0)
        buf = torch.where(take.reshape(per_kernel), rb, buf)
        flag = torch.maximum(flag, rf)
    return buf
