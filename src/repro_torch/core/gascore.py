"""The GAScore: the AM engine of every kernel (paper Sec. III-C, Fig. 3).

The hardware GAScore is a DMA engine shared by all kernels on an FPGA:
``xpams_tx``/``am_tx`` build outgoing packets (reading payloads through
the AXI DataMover), ``am_rx``/``xpams_rx`` parse incoming packets, write
Long payloads to memory, hand Medium payloads to kernels, run handlers,
and emit the automatic reply.  Here each stage is a function over
``(header rows, payload rows, state)`` for all ``K`` kernels at once:

    am_tx / DataMover read   -> :func:`egress_batch`, :func:`serve_get_batch`
                                (DataMover gather kernel)
    am_rx / DataMover write  -> :func:`ingress_long_batch`,
                                :func:`ingress_stack`,
                                :func:`ingress_strided_batch`
                                (DataMover scatter kernel)
    xpams_rx handler+reply   -> :func:`ingress_short`, ack lanes,
                                :func:`auto_reply` (plain tensor code on
                                the ``(K, NUM_TOKENS)`` credit files)

The scatter kernel applies the rows of a packet stack in order, block by
block, which is what the reference's ``lax.scan`` over rows does; on CPU
tensors its plain version loops over the rows.  Header rows are
``(K, nseg, HDR_WORDS)`` int32, payload rows ``(K, nseg, W)``.  Every
function returns a new state; the input state is not modified.
"""

from __future__ import annotations

import torch

from repro_torch.core import am
from repro_torch.core import handlers as hd
from repro_torch.core.state import PgasState, ShoalContext, replace
from repro_torch.kernels.am_pack import ops as dm

_I_NWORDS = am.FIELDS.index("nwords")
_I_SRC_ADDR = am.FIELDS.index("src_addr")


def _lane_mask(nwords: torch.Tensor, width: int,
               dtype=torch.bool) -> torch.Tensor:
    """mask[..., i] = i < nwords[...]  (valid payload lanes)."""
    return (torch.arange(width, device=nwords.device)
            < nwords[..., None]).to(dtype)


def _rows(h: am.Header) -> am.Header:
    """A one-row stack view of per-kernel ``(K,)`` header fields."""
    return am.Header(*(getattr(h, f)[:, None] for f in am.FIELDS))


def _rows_of_header(h: am.Header) -> torch.Tensor:
    return am.encode(**{f: getattr(h, f) for f in am.FIELDS})[:, None]


def _kernel_rows(x: torch.Tensor) -> torch.Tensor:
    return torch.arange(x.shape[0], device=x.device)


def _add_at(table: torch.Tensor, token: torch.Tensor,
            n: torch.Tensor) -> torch.Tensor:
    """table[k, clip(token[k])] += n[k] on a copy of a (K, NUM_TOKENS)
    counter file."""
    out = table.clone()
    tok = token.clamp(0, hd.NUM_TOKENS - 1).long()
    out[_kernel_rows(table), tok] += n.to(table.dtype)
    return out


# --------------------------------------------------------------------------
# egress: the DataMover read path
# --------------------------------------------------------------------------

def egress_batch(ctx: ShoalContext, state: PgasState, hdr_rows: torch.Tensor,
                 fifo_payload: torch.Tensor | None,
                 packet_words: int) -> torch.Tensor:
    """Build the ``(K, nseg, packet_words)`` payload rows of a whole
    segmentation plan in one DataMover gather.

    FIFO AMs read row ``b`` from word ``b * packet_words`` of the flat
    kernel payload; memory-sourced AMs read each row at its header's
    ``src_addr`` (clipped into ``[0, S]``) from the local segment.  A
    lane beyond the source's end reads 0, and every lane is multiplied
    by its mask ``lane < nwords`` as the reference does (``rows *
    mask``): a masked float lane holding NaN or +-inf stays NaN.
    """
    K, nseg = hdr_rows.shape[0], hdr_rows.shape[1]
    nwords = hdr_rows[..., _I_NWORDS]
    if fifo_payload is not None:
        src = fifo_payload.to(state.segment.dtype).reshape(K, -1).contiguous()
        addr = (torch.arange(nseg, dtype=torch.int32, device=src.device)
                * packet_words).expand(K, nseg)
    else:
        src = state.segment
        addr = hdr_rows[..., _I_SRC_ADDR].clamp(0, ctx.segment_words)
    return dm.datamover_gather(src, addr, nwords, packet_words)


def egress(ctx: ShoalContext, state: PgasState, hdr: am.Header,
           fifo_payload: torch.Tensor | None,
           packet_words: int) -> torch.Tensor:
    """Single-packet egress: a ``(K, packet_words)`` buffer.  FIFO
    payloads are zero-padded to the packet width; memory-sourced reads
    slide back so the window stays inside the segment."""
    if fifo_payload is None:
        src_addr = hdr.src_addr.clamp(0, ctx.segment_words - packet_words)
        return dm.datamover_gather(state.segment, src_addr[:, None],
                                   hdr.nwords[:, None], packet_words)[:, 0]
    rows = _rows_of_header(hdr)
    return egress_batch(ctx, state, rows, fifo_payload, packet_words)[:, 0]


# --------------------------------------------------------------------------
# ingress: the DataMover write path and the handler/credit stages
# --------------------------------------------------------------------------

def _ingress_long_rows(ctx: ShoalContext, state: PgasState, h: am.Header,
                       pay_rows: torch.Tensor) -> PgasState:
    """Land ``(K, nseg)`` Long rows in the segment, in row order, through
    each row's handler (the reference's ``_ingress_long_padded`` under a
    scan).  ``dst_addr`` clips into ``[0, S]`` and lanes past the
    segment end are dropped."""
    active = h.msg_class == am.LONG
    segment = dm.datamover_scatter(
        state.segment.clone(), pay_rows,
        h.dst_addr.clamp(0, ctx.segment_words), h.nwords, h.handler,
        active, ctx.handlers)
    rx = torch.where(active, h.nwords, 0).sum(dim=1, dtype=torch.int32)
    return replace(state, segment=segment, rx_words=state.rx_words + rx)


def ingress_long(ctx: ShoalContext, state: PgasState, hdr: am.Header,
                 payload: torch.Tensor, packet_words: int) -> PgasState:
    """Long-put ingress: payload -> shared memory via handler (am_rx
    path).  Kernels that see a NOP header keep their segment as it was."""
    return _ingress_long_rows(ctx, state, _rows(hdr), payload[:, None])


def ingress_long_batch(ctx: ShoalContext, state: PgasState,
                       hdr_rows: torch.Tensor, pay_rows: torch.Tensor,
                       packet_words: int) -> PgasState:
    """Absorb a whole ``(K, nseg, ...)`` segment stack, rows in order."""
    return _ingress_long_rows(ctx, state, am.decode(hdr_rows), pay_rows)


def ingress_medium(state: PgasState, hdr: am.Header, payload: torch.Tensor,
                   packet_words: int):
    """Medium-put ingress: deliver payload to the kernel (xpams_rx "To
    Kernels" path).  Returns ``(state, delivered)``, the payload times
    its lane mask times the kernel's active flag, as the reference
    multiplies (so a masked NaN stays NaN)."""
    active = hdr.msg_class == am.MEDIUM
    lanes = _lane_mask(hdr.nwords, packet_words, payload.dtype)
    delivered = payload * lanes * active.to(payload.dtype)[..., None]
    state = replace(state, rx_words=state.rx_words
                    + torch.where(active, hdr.nwords, 0))
    return state, delivered


def ingress_medium_batch(state: PgasState, hdr_rows: torch.Tensor,
                         pay_rows: torch.Tensor, packet_words: int):
    """Batched :func:`ingress_medium`; returns ``(state, delivered)`` with
    ``delivered`` the flattened ``(K, nseg * packet_words)`` lane stream
    (full rows first, so the first ``nwords`` lanes are the message)."""
    h = am.decode(hdr_rows)
    active = h.msg_class == am.MEDIUM
    lanes = _lane_mask(h.nwords, packet_words, pay_rows.dtype)
    delivered = pay_rows * lanes * active.to(pay_rows.dtype)[..., None]
    rx = torch.where(active, h.nwords, 0).sum(dim=1, dtype=torch.int32)
    state = replace(state, rx_words=state.rx_words + rx)
    return state, delivered.reshape(delivered.shape[0], -1)


def _ingress_strided_rows(ctx: ShoalContext, state: PgasState, h: am.Header,
                          pay_rows: torch.Tensor, blk_words: int,
                          nblocks: int) -> PgasState:
    """Scatter ``(K, nseg)`` strided rows: block ``b`` of a row lands at
    ``dst_addr + b*stride``; lanes beyond the row's ``nwords``, blocks
    beyond its ``nblocks`` and addresses outside ``[0, S)`` are dropped
    (no clipping).  Rows and blocks apply in order."""
    K, nseg = h.type.shape
    b = torch.arange(nblocks, dtype=torch.int32, device=h.type.device)
    active = (h.msg_class == am.LONG)[..., None] & (b < h.nblocks[..., None])
    addr = h.dst_addr[..., None] + b * h.stride[..., None]
    nw = (h.nwords[..., None] - b * blk_words).clamp(0, blk_words)
    handler = h.handler[..., None].expand(K, nseg, nblocks)
    segment = dm.datamover_scatter(
        state.segment.clone(),
        pay_rows.reshape(K, nseg * nblocks, blk_words),
        addr.reshape(K, -1), nw.reshape(K, -1), handler.reshape(K, -1),
        active.reshape(K, -1), ctx.handlers)
    rx = torch.where(h.msg_class == am.LONG, h.nwords, 0).sum(
        dim=1, dtype=torch.int32)
    return replace(state, segment=segment, rx_words=state.rx_words + rx)


def ingress_strided(ctx: ShoalContext, state: PgasState, hdr: am.Header,
                    payload: torch.Tensor, blk_words: int,
                    nblocks: int) -> PgasState:
    """Strided Long-put ingress: scatter blocks of ``blk_words`` to
    ``dst_addr + i*stride`` through the handler (THeGASNet's strided
    AMs).  ``nblocks``/``blk_words`` are the packet capacity; the actual
    block count is ``hdr.nblocks``.

    The DataMover scatter applies blocks in order, so overlapping blocks
    (``stride < blk_words``) get last-writer-wins and read-modify-write
    handlers see every earlier block: one path serves what the
    reference splits into this function and its block-sequential
    :func:`ingress_strided_seq`.
    """
    return _ingress_strided_rows(ctx, state, _rows(hdr), payload[:, None],
                                 blk_words, nblocks)


def ingress_strided_seq(ctx: ShoalContext, state: PgasState, hdr: am.Header,
                        payload: torch.Tensor, blk_words: int,
                        nblocks: int) -> PgasState:
    """Block-sequential strided ingress (aliasing strides): the in-order
    DataMover scatter, as :func:`ingress_strided`."""
    return ingress_strided(ctx, state, hdr, payload, blk_words, nblocks)


def ingress_strided_batch(ctx: ShoalContext, state: PgasState,
                          hdr_rows: torch.Tensor, pay_rows: torch.Tensor,
                          blk_words: int, nblocks: int) -> PgasState:
    """:func:`ingress_strided` over a ``(K, nseg, ...)`` segment stack,
    rows in order (``nblocks`` = per-row block capacity)."""
    return _ingress_strided_rows(ctx, state, am.decode(hdr_rows), pay_rows,
                                 blk_words, nblocks)


def ingress_short(ctx: ShoalContext, state: PgasState,
                  hdr: am.Header) -> PgasState:
    """Short ingress: signaling.  The handler runs on the one-word region
    ``credits[token]`` with ``dst_addr`` as its argument, so H_ADD is a
    counting semaphore; replies (FLAG_REPLY) bump the counter directly
    (reply management is absorbed into the runtime, paper Sec. III-A)."""
    is_short = hdr.msg_class == am.SHORT
    is_reply = is_short & hdr.flag(am.FLAG_REPLY)
    is_user = is_short & ~hdr.flag(am.FLAG_REPLY)
    credits = _add_at(state.credits, hdr.token, is_reply)
    tok = hdr.token.clamp(0, hd.NUM_TOKENS - 1).long()
    ks = _kernel_rows(credits)
    region = credits[ks, tok][:, None]
    arg = hdr.dst_addr.to(credits.dtype)[:, None]
    new = ctx.handlers.dispatch(hdr.handler, region, arg)
    credits[ks, tok] = torch.where(is_user[:, None], new, region)[:, 0]
    return replace(state, credits=credits)


def ingress_ack_lanes(state: PgasState, hdr: am.Header) -> PgasState:
    """The deferred-ack / piggyback lanes of one ingressed packet row.

    * FLAG_DEFER_ACK on an acked message: ledger the owed ack,
      ``deferred_acks[token] += 1``, instead of a reply exchange.
    * FLAG_PIGGYBACK: the packet carries ``pb_count`` acks owed on
      ``pb_token`` -- grant them, ``credits[pb_token] += pb_count``.
    """
    live = hdr.msg_class != am.NOP
    defer = live & hdr.flag(am.FLAG_DEFER_ACK) \
        & ~hdr.flag(am.FLAG_ASYNC) & ~hdr.flag(am.FLAG_REPLY)
    carry = live & hdr.flag(am.FLAG_PIGGYBACK)
    return replace(
        state,
        deferred_acks=_add_at(state.deferred_acks, hdr.token, defer),
        credits=_add_at(state.credits, hdr.pb_token,
                        torch.where(carry, hdr.pb_count, 0)))


def ingress_stack(ctx: ShoalContext, state: PgasState, hdr_rows: torch.Tensor,
                  pay_rows: torch.Tensor, packet_words: int) -> PgasState:
    """Mixed-class ingress for a stack of independent packet rows (the
    grouped put path): Long rows land in the segment through their
    handler (one in-order DataMover scatter for the whole stack), Short
    rows run on the credit file, ack lanes are absorbed, NOP rows do
    nothing.  Segment and credit files are disjoint, so landing every
    Long row first and then walking the rows' credit updates in order
    gives the reference's row-by-row result."""
    h = am.decode(hdr_rows)
    state = _ingress_long_rows(ctx, state, h, pay_rows)
    for r in range(hdr_rows.shape[1]):
        hr = am.decode(hdr_rows[:, r])
        state = ingress_short(ctx, state, hr)
        state = ingress_ack_lanes(state, hr)
    return state


# --------------------------------------------------------------------------
# get service and replies
# --------------------------------------------------------------------------

def serve_get_batch(ctx: ShoalContext, state: PgasState,
                    hdr_rows: torch.Tensor, packet_words: int):
    """Get service over a ``(K, nseg, HDR_WORDS)`` request stack: every
    row reads ``nwords`` at ``src_addr`` in one DataMover gather, and the
    whole response ships back as one packet stack.  Rows that are not
    get requests answer with a NOP header and data times 0.  Returns
    ``(state, resp_rows, data_rows)``.

    The reference computes ``data * mask * is_get``; gathering with
    ``nwords = 0`` on rows that are not gets gives ``data * (mask &
    is_get)``, the same bits for every word (NaN included)."""
    h = am.decode(hdr_rows)
    is_get = h.flag(am.FLAG_GET)
    data = dm.datamover_gather(
        state.segment, h.src_addr.clamp(0, ctx.segment_words),
        torch.where(is_get, h.nwords, 0), packet_words)
    resp_type = torch.where(
        is_get, h.msg_class | am.FLAG_REPLY | am.FLAG_ASYNC, 0)
    resp = am.encode(type=resp_type, src=h.dst, dst=h.src, nwords=h.nwords,
                     dst_addr=h.dst_addr, token=h.token, handler=h.handler,
                     seq=h.seq)
    resp = torch.where(is_get[..., None], resp, 0)
    tx = torch.where(is_get, h.nwords, 0).sum(dim=1, dtype=torch.int32)
    return replace(state, tx_words=state.tx_words + tx), resp, data


def serve_get(ctx: ShoalContext, state: PgasState, hdr: am.Header,
              packet_words: int):
    """Get-request service for one packet per kernel; returns
    ``(state, resp_hdr, data)``.  The response is marked as a reply so
    the requester's credit bumps on receipt."""
    state, resp, data = serve_get_batch(ctx, state, _rows_of_header(hdr),
                                        packet_words)
    return state, resp[:, 0], data[:, 0]


def auto_reply(hdr: am.Header) -> torch.Tensor:
    """The automatic reply header for an acked AM; NOP (all-zero) when
    the message was asynchronous, a NOP, itself a reply, or defer-acked
    (the owed ack rides a later packet's piggyback lane)."""
    rep = am.reply_for(hdr)
    suppress = (hdr.msg_class == am.NOP) | hdr.flag(am.FLAG_ASYNC) \
        | hdr.flag(am.FLAG_REPLY) | hdr.flag(am.FLAG_DEFER_ACK)
    return torch.where(suppress[..., None], 0, rep)


def ingress_reply(state: PgasState, hdr: am.Header) -> PgasState:
    """Reply ingress at the original sender: bump credits[token]."""
    return replace(state, credits=_add_at(state.credits, hdr.token,
                                          hdr.flag(am.FLAG_REPLY)))
