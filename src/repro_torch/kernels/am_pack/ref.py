"""Plain PyTorch versions of the DataMover gather/scatter kernels.

They compute what ``csrc/am_pack.cu`` computes, on any device; the
wrappers in :mod:`repro_torch.kernels.am_pack.ops` take them for CPU
tensors only.  Shapes: ``seg (K, S)``, per-block ``addr``, ``nwords``,
``handler``, ``active`` ``(K, B)``, packet rows ``(K, B, W)``.
"""

from __future__ import annotations

import torch

from repro_torch.core import handlers as hd


def datamover_gather_ref(seg: torch.Tensor, addr: torch.Tensor,
                         nwords: torch.Tensor, W: int) -> torch.Tensor:
    """``out[k, b, j] = v * (j < nwords[k, b])`` with ``v = seg[k,
    addr[k, b] + j]`` for an address inside the segment, else 0: a
    float lane past ``nwords`` is ``v * 0`` (NaN for NaN or +-inf, -0.0
    for a negative word), as the reference GAScore's ``rows * mask``."""
    K, S = seg.shape
    B = addr.shape[1]
    lanes = torch.arange(W, device=seg.device)
    idx = addr[..., None].long() + lanes
    inside = (idx >= 0) & (idx < S)
    vals = seg.gather(1, idx.clamp(0, max(S - 1, 0)).reshape(K, B * W))
    vals = torch.where(inside, vals.reshape(K, B, W), 0)
    return vals * (lanes < nwords[..., None]).to(seg.dtype)


def datamover_scatter_ref(seg: torch.Tensor, pay: torch.Tensor,
                          addr: torch.Tensor, nwords: torch.Tensor,
                          handler: torch.Tensor, active: torch.Tensor,
                          table: hd.HandlerTable | None = None
                          ) -> torch.Tensor:
    """Apply every block to ``seg`` in place, in block order per kernel
    row: ``seg[k, addr + j] = handler(seg[k, addr + j], pay[k, b, j])``
    for ``j < nwords``, active blocks and addresses inside the segment.
    Returns ``seg``."""
    table = hd.DEFAULT_TABLE if table is None else table
    K, S = seg.shape
    B, W = pay.shape[1], pay.shape[2]
    ext = torch.cat([seg, seg.new_zeros(K, 1)], dim=1)  # column S: sink
    lanes = torch.arange(W, device=seg.device)
    for b in range(B):
        idx = addr[:, b, None].long() + lanes
        valid = (active[:, b, None] != 0) & (lanes < nwords[:, b, None]) \
            & (idx >= 0) & (idx < S)
        idx = torch.where(valid, idx, S)
        region = ext.gather(1, idx)
        new = table.dispatch(handler[:, b], region, pay[:, b])
        ext.scatter_(1, idx, torch.where(valid, new, region))
    seg.copy_(ext[:, :S])
    return seg


def block_starts(segment: torch.Tensor, addr: int, stride: int,
                 blk_words: int, nblocks: int) -> torch.Tensor:
    """``(1, nblocks)`` int32 start of every block of ``am_pack`` /
    ``am_unpack``: ``addr + i*stride`` taken as ``dynamic_slice`` and
    ``dynamic_update_slice`` take it in the TPU kernels -- a negative
    start counts from the segment's end, then every block slides back
    inside the 1-D segment (start clamped to ``[0, S - blk_words]``)."""
    S = segment.shape[0]
    starts = addr + stride * torch.arange(nblocks, dtype=torch.int32,
                                          device=segment.device)[None]
    starts = torch.where(starts < 0, starts + S, starts)
    return starts.clamp(0, max(S - blk_words, 0))


def am_pack_ref(segment: torch.Tensor, addr: int, stride: int,
                blk_words: int, nblocks: int) -> torch.Tensor:
    """Gather ``nblocks`` blocks of ``blk_words`` at addr + i*stride
    (slid inside the segment) from a 1-D segment into a contiguous
    payload."""
    starts = block_starts(segment, addr, stride, blk_words, nblocks)
    lanes = torch.arange(blk_words, device=segment.device)
    return segment[(starts[0, :, None] + lanes).reshape(-1)]


def am_unpack_ref(segment: torch.Tensor, payload: torch.Tensor, addr: int,
                  stride: int, blk_words: int, nblocks: int) -> torch.Tensor:
    """Scatter a packed payload back at addr + i*stride (slid inside the
    segment) into a copy of ``segment``, blocks in order (the last writer
    wins where they overlap)."""
    out = segment.clone()[None]
    addrs = block_starts(segment, addr, stride, blk_words, nblocks)
    ones = torch.ones_like(addrs)
    datamover_scatter_ref(out, payload.to(segment.dtype).reshape(
        1, nblocks, blk_words), addrs, ones * blk_words, ones * hd.H_WRITE,
        ones)
    return out[0]
