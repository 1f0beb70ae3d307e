"""DataMover wrappers: the CUDA kernel for CUDA tensors, the plain
version for CPU tensors, and nothing else (no fallback)."""

from __future__ import annotations

import torch

from repro_torch.core import handlers as hd
from repro_torch.kernels.am_pack.am_pack import (datamover_gather_cuda,
                                                 datamover_scatter_cuda)
from repro_torch.kernels.am_pack.ref import (block_starts,
                                             datamover_gather_ref,
                                             datamover_scatter_ref)


def _i32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32).contiguous()


def datamover_gather(seg: torch.Tensor, addr: torch.Tensor,
                     nwords: torch.Tensor, W: int) -> torch.Tensor:
    """Read ``(K, B, W)`` packet rows from ``seg (K, S)``: row ``(k, b)``
    holds ``nwords[k, b]`` words from ``addr[k, b]``; a lane past
    ``nwords`` is the word there times 0 (zero, -0.0 or NaN), and a
    lane whose address leaves the segment reads 0."""
    if seg.device.type == "cpu":
        return datamover_gather_ref(seg, addr, nwords, W)
    return datamover_gather_cuda(seg, _i32(addr), _i32(nwords), W)


def datamover_scatter(seg: torch.Tensor, pay: torch.Tensor,
                      addr: torch.Tensor, nwords: torch.Tensor,
                      handler: torch.Tensor, active: torch.Tensor,
                      table: hd.HandlerTable | None = None) -> torch.Tensor:
    """Land packet rows ``pay (K, B, W)`` in ``seg (K, S)`` in place,
    block by block in order, through each block's handler.  Returns
    ``seg``.  On CUDA a table of the built-in handlers is one launch of
    the scatter kernel, which runs them itself; a table with custom
    handlers lands block by block (:func:`scatter_through_handlers`),
    two launches a block."""
    table = hd.DEFAULT_TABLE if table is None else table
    if seg.device.type == "cpu":
        return datamover_scatter_ref(seg, pay, addr, nwords, handler, active,
                                     table)
    if not table.builtin_only:
        return scatter_through_handlers(seg, pay, addr, nwords, handler,
                                        active, table, _gather_cuda,
                                        _scatter_cuda)
    return _scatter_cuda(seg, pay, addr, nwords, handler, active)


def _gather_cuda(seg, addr, nwords, W):
    return datamover_gather_cuda(seg, _i32(addr), _i32(nwords), W)


def _scatter_cuda(seg, pay, addr, nwords, handler, active):
    return datamover_scatter_cuda(seg, pay.to(seg.dtype).contiguous(),
                                  _i32(addr), _i32(nwords), _i32(handler),
                                  _i32(active))


def scatter_through_handlers(seg, pay, addr, nwords, handler, active,
                             table: hd.HandlerTable, gather, scatter):
    """:func:`datamover_scatter` with any handler table, block by block
    in block order: ``gather(seg, addr, nwords, W)`` reads the block's
    region ``(K, 1, W)``, ``table.dispatch`` computes the new region
    from it and the block's payload (handler ids clipped into the
    table), and ``scatter`` writes it with ``H_WRITE`` under the block's
    ``active``, ``nwords`` and in-segment masks, so a later block sees
    every earlier one.  The kernels move the bytes; the handler's
    arithmetic is the caller's tensor function, as the JAX package runs
    ``lax.switch`` outside its Pallas kernels.  On a CUDA segment
    ``gather`` and ``scatter`` are the DataMover kernels' wrappers, on
    the CPU their plain versions.  Returns ``seg``."""
    W = pay.shape[2]
    write = torch.full((seg.shape[0], 1), hd.H_WRITE, dtype=torch.int32,
                       device=seg.device)
    for b in range(pay.shape[1]):
        blk = slice(b, b + 1)
        region = gather(seg, addr[:, blk], nwords[:, blk], W)
        new = table.dispatch(handler[:, blk], region, pay[:, blk])
        scatter(seg, new.to(seg.dtype), addr[:, blk], nwords[:, blk], write,
                active[:, blk])
    return seg


def am_pack(segment: torch.Tensor, addr: int, stride: int, blk_words: int,
            nblocks: int) -> torch.Tensor:
    """Gather ``nblocks`` blocks of ``blk_words`` at ``addr + i*stride``
    from a 1-D segment into one contiguous payload.  A block that runs
    past either end of the segment slides back inside, as in
    ``am_pack_pallas``."""
    addrs = block_starts(segment, addr, stride, blk_words, nblocks)
    rows = datamover_gather(segment.reshape(1, -1).contiguous(), addrs,
                            torch.full_like(addrs, blk_words), blk_words)
    return rows.reshape(-1)


def am_unpack(segment: torch.Tensor, payload: torch.Tensor, addr: int,
              stride: int, blk_words: int, nblocks: int) -> torch.Tensor:
    """Scatter a packed payload back at ``addr + i*stride`` into a copy
    of ``segment``, blocks in order (the last writer wins).  A block that
    runs past either end of the segment slides back inside, as in
    ``am_unpack_pallas``; the GAScore's ingress paths drop such lanes
    instead and call :func:`datamover_scatter` directly."""
    out = segment.reshape(1, -1).clone()
    addrs = block_starts(segment, addr, stride, blk_words, nblocks)
    ones = torch.ones_like(addrs)
    datamover_scatter(out, payload.reshape(1, nblocks, blk_words), addrs,
                      ones * blk_words, ones * hd.H_WRITE, ones)
    return out.reshape(segment.shape)
