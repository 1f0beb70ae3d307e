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
                                :func:`ingress_reliable_stack`,
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

import dataclasses

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
                       pay_rows: torch.Tensor,
                       gate: torch.Tensor | None = None) -> PgasState:
    """Land ``(K, nseg)`` Long rows in the segment, in row order, through
    each row's handler (the reference's ``_ingress_long_padded`` under a
    scan).  ``dst_addr`` clips into ``[0, S]`` and lanes past the
    segment end are dropped.  ``gate`` (``(K, nseg)`` bool) further
    restricts which rows apply (the reliable path's dedup verdict)."""
    active = h.msg_class == am.LONG
    if gate is not None:
        active = active & gate
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


def ingress_vectored(ctx: ShoalContext, state: PgasState, h: am.Header,
                     addrs: torch.Tensor, payload: torch.Tensor,
                     sizes: list[int]) -> PgasState:
    """Vectored Long-put ingress: block ``i`` of the flat ``(K, nwords)``
    payload (``sizes[i]`` words) lands at ``addrs[:, i]`` through the
    packet's handler.  The ``B`` blocks are the rows of ONE in-order
    DataMover scatter (the reference runs one ``ingress_long`` per
    block); blocks of one size are a view of the payload, ragged ones
    come out of one DataMover gather, each row ``sizes[i]`` words at
    its offset.  Kernels that see a NOP header keep their segment."""
    K, B = addrs.shape
    dev = payload.device
    size = torch.tensor(sizes, dtype=torch.int32, device=dev).expand(K, B)
    if len(set(sizes)) == 1:
        rows = payload.reshape(K, B, sizes[0])
    else:
        offs = torch.tensor([sum(sizes[:i]) for i in range(B)],
                            dtype=torch.int32, device=dev).expand(K, B)
        rows = dm.datamover_gather(payload.contiguous(), offs, size,
                                   max(sizes))
    sub = am.Header(**{f: getattr(h, f)[:, None].expand(K, B)
                       for f in am.FIELDS})
    sub = dataclasses.replace(sub, nwords=size, dst_addr=addrs)
    return _ingress_long_rows(ctx, state, sub, rows)


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


def _credit_walk(ctx: ShoalContext, state: PgasState,
                 hdr_rows: torch.Tensor) -> PgasState:
    """The rows' Short and ack-lane updates one row after another."""
    for r in range(hdr_rows.shape[1]):
        hr = am.decode(hdr_rows[:, r])
        state = ingress_short(ctx, state, hr)
        state = ingress_ack_lanes(state, hr)
    return state


def _credit_rows(ctx: ShoalContext, state: PgasState,
                 hdr_rows: torch.Tensor, additive: bool | None = None
                 ) -> PgasState:
    """The Short and ack-lane updates of a ``(K, R)`` row stack on the
    credit files.  When every user Short row runs H_ADD or H_NOP, every
    update is an int32 addition (replies +1, H_ADD +arg, deferred acks
    +1, piggybacked acks +pb_count): additions commute and wrap alike
    in any order, so three scatter-adds give the row-by-row walk's
    bits.  A stack with any other Short handler (write, max, min,
    custom) is walked in row order.  ``additive`` is the caller's
    knowledge of its rows (True: only adding Short handlers, False:
    walk); None reads one bool back from the device to decide."""
    h = am.decode(hdr_rows)
    short = h.msg_class == am.SHORT
    is_reply = short & h.flag(am.FLAG_REPLY)
    is_user = short & ~h.flag(am.FLAG_REPLY)
    hid = h.handler.clamp(0, len(ctx.handlers) - 1)
    if additive is None:
        additive = not bool(
            (is_user & (hid != hd.H_ADD) & (hid != hd.H_NOP)).any())
    if not additive:
        return _credit_walk(ctx, state, hdr_rows)
    live = h.msg_class != am.NOP
    defer = live & h.flag(am.FLAG_DEFER_ACK) \
        & ~h.flag(am.FLAG_ASYNC) & ~h.flag(am.FLAG_REPLY)
    carry = live & h.flag(am.FLAG_PIGGYBACK)
    top = hd.NUM_TOKENS - 1
    tok = h.token.clamp(0, top).long()
    grant = is_reply.to(torch.int32) + torch.where(
        is_user & (hid == hd.H_ADD), h.dst_addr, 0)
    credits = state.credits.clone()
    credits.scatter_add_(1, tok, grant.to(credits.dtype))
    credits.scatter_add_(1, h.pb_token.clamp(0, top).long(),
                         torch.where(carry, h.pb_count, 0).to(credits.dtype))
    deferred = state.deferred_acks.clone()
    deferred.scatter_add_(1, tok, defer.to(deferred.dtype))
    return replace(state, credits=credits, deferred_acks=deferred)


def adds_only(handlers: hd.HandlerTable, short_handlers) -> bool | None:
    """Whether every handler a stack's user Short rows may carry adds
    (H_ADD, or H_NOP) once clipped into ``handlers``: the ``additive``
    of :func:`ingress_stack`.  ``short_handlers`` are ints, or None for
    one not known on the host (then None: decide on the device)."""
    last = len(handlers) - 1
    out = True
    for h in short_handlers:
        if h is None:
            return None
        out &= min(max(int(h), 0), last) in (hd.H_ADD, hd.H_NOP)
    return out


def ingress_stack(ctx: ShoalContext, state: PgasState, hdr_rows: torch.Tensor,
                  pay_rows: torch.Tensor, packet_words: int, *,
                  additive: bool | None = None) -> PgasState:
    """Mixed-class ingress for a stack of independent packet rows (the
    grouped put and mailbox flush paths): Long rows land in the segment
    through their handler (one in-order DataMover scatter for the whole
    stack), Short rows run on the credit file, ack lanes are absorbed,
    NOP rows do nothing.  Segment and credit files are disjoint, so
    landing every Long row first and then applying the rows' credit
    updates (:func:`_credit_rows`, ``additive`` as there) gives the
    reference's row-by-row result."""
    h = am.decode(hdr_rows)
    state = _ingress_long_rows(ctx, state, h, pay_rows)
    return _credit_rows(ctx, state, hdr_rows, additive)


def ingress_reliable_stack(ctx: ShoalContext, state: PgasState,
                           hdr_rows: torch.Tensor, pay_rows: torch.Tensor,
                           packet_words: int, *, dedup: bool = True):
    """Dedup-gated Long-stack ingress for the lossy-transport path.

    Rows arrive out of a faulted exchange (drops and CRC-failed rows
    already NOPed, duplicates materialised as extra rows -- see
    :func:`repro_torch.core.faults.deliver`), possibly REDELIVERED by a
    sender retransmitting after a lost ack.  The redelivery ledger makes
    application idempotent, keyed on (token, epoch, seq):

    * a row whose epoch is <= the last *completed* epoch on its token is
      stale -- not applied, but a stale FINAL row still re-acks (the
      data landed earlier; it is the ack that keeps dying);
    * an in-flight row applies only if its segment bit is not yet in
      ``dedup_seen[token]``, then sets the bit (a duplicate later in
      the same stack sees it);
    * when the final (non-async) row finds the arrival mask complete
      (bits 0..seg_final all set), the message completes:
      ``dedup_epoch[token]`` latches the epoch and the mask drains to
      zero.

    The verdicts walk the rows in order on ``(K,)`` tensors (the
    reference's scan carry); then every fresh Long row lands in ONE
    gated DataMover scatter, rows in order.  Segment stacks are limited
    to 31 rows so the arrival mask fits an int32.  ``dedup=False``
    applies every delivered row and acks every final row (a
    retransmitted H_ADD double-accumulates).

    Returns ``(state, ack_hdr)``: ``ack_hdr`` ``(K, HDR_WORDS)`` is the
    reply owed this round, that of the last row that completed or
    re-acked (NOP where none did).
    """
    h = am.decode(hdr_rows)
    K, R = h.type.shape
    active = h.msg_class == am.LONG
    is_final = active & ~h.flag(am.FLAG_ASYNC) & ~h.flag(am.FLAG_REPLY)
    if dedup:
        ks = _kernel_rows(hdr_rows)
        tok = h.token.clamp(0, hd.NUM_TOKENS - 1).long()
        seg_i = (h.seq // packet_words).clamp(0, 30).to(torch.int64)
        bit = (1 << seg_i).to(torch.int32)
        full = ((1 << (seg_i + 1)) - 1).to(torch.int32)
        done_f = state.dedup_epoch.clone()
        infl_f = state.dedup_inflight.clone()
        seen_f = state.dedup_seen.clone()
        fresh = torch.zeros_like(active)
        ack_now = torch.zeros_like(active)
        for r in range(R):
            t, a, ep, b = tok[:, r], active[:, r], h.epoch[:, r], bit[:, r]
            done, infl, seen0 = done_f[ks, t], infl_f[ks, t], seen_f[ks, t]
            stale = a & (ep <= done)
            track = a & ~stale
            seen = torch.where(infl == ep, seen0, 0)
            fresh[:, r] = track & ((seen & b) == 0)
            seen2 = torch.where(track, seen | b, seen)
            complete = is_final[:, r] & ~stale & (seen2 == full[:, r])
            done_f[ks, t] = torch.where(complete, ep, done)
            infl_f[ks, t] = torch.where(track, ep, infl)
            seen_f[ks, t] = torch.where(
                complete, 0, torch.where(track, seen2, seen0))
            ack_now[:, r] = complete | (stale & is_final[:, r])
        state = replace(state, dedup_epoch=done_f, dedup_inflight=infl_f,
                        dedup_seen=seen_f)
    else:
        fresh, ack_now = active, is_final
    state = _ingress_long_rows(ctx, state, h, pay_rows, gate=fresh)
    order = torch.arange(1, R + 1, device=hdr_rows.device)
    last = (ack_now * order).amax(dim=1) - 1
    row = hdr_rows[_kernel_rows(hdr_rows), last.clamp(min=0)]
    ack_hdr = torch.where((last >= 0)[:, None], am.reply_for(am.decode(row)),
                          0)
    return state, ack_hdr


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
