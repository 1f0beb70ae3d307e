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

Each call of a ring collective, of ``all_to_all_vectored`` and of
``tree_barrier`` on more than one kernel also adds one to its kind in
``ctx.collectives`` (``reduce_scatter``, ``all_gather``, ``all_reduce``,
``all_to_all``; the barrier is an all-reduce, ``lax.psum`` in the JAX
package): one op per collective, as a compiled program counts them,
whatever its traversals.  ``broadcast_from`` is permutes only.  Each
launch of the ring kernel adds its bytes to its kind in
``ctx.ring_bytes``: the stacked input read once and the output written
once.  While :mod:`repro_torch.runtime.spans` records, each ring launch
and each all-to-all is a ``shoal.<kind>`` span whose attrs hold ``K``,
those bytes and the exchanges it added.

The ring collectives and ``all_to_all_vectored`` are differentiable.
When their input requires grad they run as a ``torch.autograd.Function``
whose backward is the adjoint collective through the same
``ring_collective`` (the ring kernel on a CUDA context): reduce-scatter
and all-gather are each other's adjoint, an all-reduce is its own, and
the all-to-all's block transpose is its own inverse.  The adjoint of
the reduce-scatter's zero pad is a slice.  A backward call counts what
the forward call counts, under the kind it runs: ``n - 1`` exchanges and
one ``all_gather`` for a reduce-scatter's cotangent, ``n - 1`` and one
``reduce_scatter`` for an all-gather's, ``2(n - 1)`` and one
``all_reduce`` for an all-reduce's, one and one ``all_to_all`` for the
all-to-all's.  The ring adjoints reduce in float32 (the JAX island's
float32 boundary) and hand back the input's dtype; the all-to-all moves
its cotangent unchanged, which is exact in any dtype.  Without an input
that requires grad, each call runs as the plain collective.
"""

from __future__ import annotations

import torch

from repro_torch.core import ops
from repro_torch.core.state import COLLECTIVE_KINDS, ShoalContext
from repro_torch.kernels.gascore_dma import (ALL_GATHER, ALL_REDUCE,
                                             REDUCE_SCATTER, ring_collective)
from repro_torch.runtime import spans


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


_SPANS = {kind: f"shoal.{kind}" for kind in COLLECTIVE_KINDS}


def _ring_launch(ctx: ShoalContext, kind: str, buf: torch.Tensor, schedule,
                 exchanges: int) -> torch.Tensor:
    """One launch of the ring kernel: counts its ``exchanges``, its call
    and its bytes (``ctx.ring_bytes``) under ``kind``, in a
    ``shoal.<kind>`` span that records them."""
    with spans.span(_SPANS[kind], K=ctx.num_kernels) as span:
        out = ring_collective(buf, schedule)
        ctx.exchanges += exchanges
        ctx.collectives[kind] += 1
        nbytes = buf.nbytes + out.nbytes
        ctx.ring_bytes[kind] += nbytes
        if span is not None:
            span.attrs.update(bytes=nbytes, exchanges=exchanges)
    return out


def _reduce_scatter(ctx: ShoalContext, x: torch.Tensor) -> torch.Tensor:
    n = ctx.num_kernels
    if n == 1:
        return x.reshape(1, -1)
    buf, _ = _pad_to_chunks(x, n)
    return _ring_launch(ctx, "reduce_scatter", buf, REDUCE_SCATTER, n - 1)


def _all_gather(ctx: ShoalContext, chunk: torch.Tensor) -> torch.Tensor:
    chunk = chunk.reshape(chunk.shape[0], -1)
    n = ctx.num_kernels
    if n == 1:
        return chunk[:, None]
    return _ring_launch(ctx, "all_gather", chunk.contiguous(), ALL_GATHER,
                        n - 1)


def _all_reduce(ctx: ShoalContext, x: torch.Tensor) -> torch.Tensor:
    n = ctx.num_kernels
    if n == 1:
        return x
    buf, pad = _pad_to_chunks(x, n)
    full = _ring_launch(ctx, "all_reduce", buf, ALL_REDUCE,
                        2 * (n - 1)).reshape(x.shape[0], -1)
    return full[:, :full.shape[1] - pad].reshape(x.shape)


def _all_to_all(ctx: ShoalContext, x: torch.Tensor,
                tiled: bool) -> torch.Tensor:
    n = ctx.num_kernels
    m = x.shape[1]
    if (m % n if tiled else m != n):
        raise ValueError(f"all_to_all_vectored: leading dimension {m} of "
                         f"each kernel's value does not split into {n} "
                         f"blocks (tiled={tiled})")
    if n == 1:
        return x
    with spans.span("shoal.all_to_all", K=n) as span:
        ctx.exchanges += 1
        ctx.collectives["all_to_all"] += 1
        blocks = x.reshape(n, n, m // n, *x.shape[2:])
        out = blocks.transpose(0, 1).reshape(x.shape)
        if span is not None:
            span.attrs.update(bytes=2 * x.nbytes, exchanges=1)
        return out


def _rs_adjoint(ctx: ShoalContext, g: torch.Tensor, shape) -> torch.Tensor:
    """A reduce-scatter input's cotangent: the all-gather of the chunks'
    cotangents ``g (K, chunk)``, the pad sliced off."""
    full = _all_gather(ctx, g).reshape(shape[0], -1)
    return full[:, :shape[1:].numel()].reshape(shape)


def _ag_adjoint(ctx: ShoalContext, g: torch.Tensor, shape) -> torch.Tensor:
    """An all-gather input's cotangent: the reduce-scatter of ``g (K, n,
    c)`` (``n c`` words a kernel, so no pad)."""
    return _reduce_scatter(ctx, g).reshape(shape)


def _ar_adjoint(ctx: ShoalContext, g: torch.Tensor, shape) -> torch.Tensor:
    return _all_reduce(ctx, g)


class _RingCollective(torch.autograd.Function):
    """A ring collective ``fwd`` whose backward is ``adjoint`` on the
    float32 cotangent (module docstring)."""

    @staticmethod
    def forward(fc, ctx, fwd, adjoint, x):
        fc.ctx, fc.adjoint, fc.shape, fc.dtype = ctx, adjoint, x.shape, \
            x.dtype
        return fwd(ctx, x)

    @staticmethod
    def backward(fc, g):
        dx = fc.adjoint(fc.ctx, g.float(), fc.shape).to(fc.dtype)
        return None, None, None, dx


class _AllToAll(torch.autograd.Function):
    """The vectored all-to-all; its backward is the same block
    transpose."""

    @staticmethod
    def forward(fc, ctx, x, tiled):
        fc.ctx, fc.tiled = ctx, tiled
        return _all_to_all(ctx, x, tiled)

    @staticmethod
    def backward(fc, g):
        return None, _all_to_all(fc.ctx, g, fc.tiled), None


class _Broadcast(torch.autograd.Function):
    """A broadcast over the kernel axis whose backward is one float32
    ring all-reduce of the kernels' cotangents."""

    @staticmethod
    def forward(fc, ctx, x):
        fc.ctx, fc.dtype = ctx, x.dtype
        return x.expand(ctx.num_kernels, *x.shape)

    @staticmethod
    def backward(fc, g):
        return None, _all_reduce(fc.ctx, g.float())[0].to(fc.dtype)


def _tracked(ctx: ShoalContext, x: torch.Tensor) -> bool:
    """Whether the call needs the autograd edge: more than one kernel
    and an input that requires grad under grad mode."""
    return (ctx.num_kernels > 1 and torch.is_grad_enabled()
            and x.requires_grad)


def ring_reduce_scatter(ctx: ShoalContext, x: torch.Tensor) -> torch.Tensor:
    """Ring reduce-scatter of every kernel's full-size addend ``x (K,
    ...)``; returns ``(K, chunk)``, kernel ``k``'s reduced chunk ``k``
    (``chunk = ceil(size / n)``).  ``n - 1`` one-sided neighbour puts
    with the ADD handler."""
    if _tracked(ctx, x):
        return _RingCollective.apply(ctx, _reduce_scatter, _rs_adjoint,
                                     x)
    return _reduce_scatter(ctx, x)


def ring_all_gather(ctx: ShoalContext, chunk: torch.Tensor) -> torch.Tensor:
    """Ring all-gather: every kernel contributes ``chunk (K, ...)``;
    returns ``(K, n, c)``, every kernel holding all chunks in kernel
    order.  ``n - 1`` one-sided neighbour puts."""
    if _tracked(ctx, chunk):
        return _RingCollective.apply(ctx, _all_gather, _ag_adjoint, chunk)
    return _all_gather(ctx, chunk)


def ring_all_reduce(ctx: ShoalContext, x: torch.Tensor) -> torch.Tensor:
    """Ring all-reduce = reduce-scatter + all-gather, one kernel launch
    (``2(n - 1)`` puts of ``size / n`` words each: bandwidth-optimal).
    Returns ``x.shape``, every kernel's row the sum over kernels."""
    if _tracked(ctx, x):
        return _RingCollective.apply(ctx, _all_reduce, _ar_adjoint, x)
    return _all_reduce(ctx, x)


def all_to_all_vectored(ctx: ShoalContext, x: torch.Tensor, *,
                        tiled: bool = True) -> torch.Tensor:
    """Vectored-AM all-to-all: kernel ``i``'s block ``j`` lands at kernel
    ``j`` slot ``i`` (the Shoal Vectored Long put over all kernel pairs,
    one exchange).  Each kernel's ``x[k]`` has a leading dimension of
    ``n`` blocks (``tiled=True``: a multiple of ``n``, cut into ``n``
    blocks; ``tiled=False``: exactly ``n`` one-row blocks), as
    ``lax.all_to_all(split_axis=0, concat_axis=0)`` takes it."""
    if _tracked(ctx, x):
        return _AllToAll.apply(ctx, x, tiled)
    return _all_to_all(ctx, x, tiled)


def broadcast_to_kernels(ctx: ShoalContext, x: torch.Tensor) -> torch.Tensor:
    """``x`` seen by every kernel: ``(K, *x.shape)``, a broadcast view.
    Its backward sums the kernels' cotangents with one ring all-reduce
    (counted), the collective the JAX package's ``shard_map`` transpose
    inserts for an input every kernel reads whole (a ``psum`` over the
    axis the input is replicated on)."""
    if _tracked(ctx, x):
        return _Broadcast.apply(ctx, x)
    return x.expand(ctx.num_kernels, *x.shape)


def tree_barrier(ctx: ShoalContext) -> torch.Tensor:
    """The dataflow barrier: a sum of one unit per kernel, ``(K,)`` int32
    all equal to ``n``.  A reduction, no link traversal (as
    :func:`repro_torch.core.ops.barrier`), one all-reduce call."""
    if ctx.num_kernels > 1:
        ctx.collectives["all_reduce"] += 1
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
