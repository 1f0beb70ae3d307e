"""The Shoal communication API (paper Sec. III-A) over a kernel axis.

Every function here is the collective form of a Shoal AM call: one call
acts for all ``K`` kernels at once; ``pattern`` is a list of
``(src_kernel, dst_kernel)`` pairs naming who actually communicates, and
kernels outside the pattern contribute NOP headers (no action, no
reply).  A put is ONE link traversal (plus an optional auto-reply), with
no rendezvous.

Wire model: one exchange per link traversal.  Header and payload fuse
into a single int32 packet (:func:`repro_torch.core.am.pack_packet`),
and an exchange moves packet ``src`` to kernel ``dst`` for every pair of
the pattern with one gather over the kernel axis; kernels that receive
nothing get zeros.  ``ctx.exchanges`` counts the gathers.

Message-size segmentation: AMs whose payload exceeds the transport's
``max_packet_words`` split into sequence-numbered packets stacked into
one ``(K, nseg, HDR_WORDS + packet_words)`` buffer, shipped with a
single exchange and absorbed in row order by the GAScore.  Replies
coalesce (every segment but the last is async), so an acked >MTU
message costs 2 link traversals and earns ONE credit.

Lossy transports: on a :class:`~repro_torch.runtime.transport.
LossyTransport` with a non-zero fault model, ``put_long`` runs the
reliable put (CRC-sealed, epoch-stamped packets, receiver-side dedup,
bounded retransmit -- :func:`_put_long_reliable`); every other op
refuses such a transport.

Ops take a :class:`~repro_torch.core.state.PgasState` and return a new
one.  Per-kernel arguments (addresses, tokens, wait counts) are ints or
``(K,)`` tensors; payloads are ``(K, ...)``.

shoal-lint hooks: while a recorder of :mod:`repro_torch.analysis.trace`
is active, every op emits one comm event with its host-known operands
(a tensor operand is recorded as unknown, never read) and runs inside
its event's scope, which attributes the op's exchanges to it.  With no
recorder active the hooks build nothing.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.analysis import trace as _lint
from repro_torch.analysis.trace import Interval, static_int
from repro_torch.core import am
from repro_torch.core import faults as flt
from repro_torch.core import gascore as gc
from repro_torch.core import handlers as hd
from repro_torch.core.state import (ERR_CRC, ERR_RETRY_EXHAUSTED,
                                    ERR_WAIT_UNDERFLOW, PgasState,
                                    ShoalContext, replace)
from repro_torch.runtime.transport import is_lossy as _transport_is_lossy

Pattern = list[tuple[int, int]]


class VectoredAliasError(ValueError):
    """A vectored or batched put's destination intervals alias each
    other at one destination kernel (two blocks of one packet, or two
    items of one batched call), so the landed value would depend on the
    receiver's scatter order -- duplicate addresses are the degenerate
    case.  Packets that overlap on purpose are wrapped in
    ``repro_torch.analysis.waiver(reason)``, which ships them and
    records the hazard as a waived R4 finding."""


# --------------------------------------------------------------------------
# pattern plumbing
# --------------------------------------------------------------------------

def _reverse(pattern: Pattern) -> Pattern:
    return [(d, s) for (s, d) in pattern]


def _is_sender(ctx: ShoalContext, pattern: Pattern) -> torch.Tensor:
    """``(K,)`` bool: does kernel k send in this pattern?"""
    return ctx.pattern(pattern).sender


def _dst_of(ctx: ShoalContext, pattern: Pattern) -> torch.Tensor:
    """``(K,)`` int32 destination of every kernel (or -1)."""
    return ctx.pattern(pattern).dst


def _col(x):
    """A per-kernel ``(K,)`` tensor as a ``(K, 1)`` column of a row
    stack; ints pass through."""
    return x[:, None] if torch.is_tensor(x) and x.dim() == 1 else x


def _permute(ctx: ShoalContext, pattern: Pattern,
             x: torch.Tensor) -> torch.Tensor:
    """One exchange: ``out[d] = x[s]`` for every ``(s, d)`` of the
    pattern, zeros on kernels that receive nothing.  Under autograd (an
    input that requires grad, grad mode on) the backward is one exchange
    more: the cotangents handed back along the reversed pattern, as the
    transpose of the reference's ``ppermute`` is the reverse
    ``ppermute``."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Handoff.apply(ctx, pattern, x)
    table = ctx.pattern(pattern)
    ctx.exchanges += 1
    _lint.note_exchange()
    out = torch.zeros_like(x)
    out[table.dsts] = x[table.srcs]
    return out


class _Handoff(torch.autograd.Function):
    """:func:`_permute` with a counted backward: the reversed pattern
    through :func:`_permute` itself.  A pattern is a partial permutation
    (``ShoalContext.pattern`` refuses any other), so each source gets
    the cotangent of its one destination and a kernel that sent nothing
    gets zeros, as the index copy's own backward gives them."""

    @staticmethod
    def forward(fc, ctx, pattern, x):
        fc.ctx, fc.pattern = ctx, pattern
        return _permute(ctx, pattern, x)

    @staticmethod
    def backward(fc, g):
        return None, None, _permute(fc.ctx, _reverse(fc.pattern), g)


def _exchange(ctx: ShoalContext, pattern: Pattern, hdr: torch.Tensor,
              payload: torch.Tensor | None,
              extra: torch.Tensor | None = None):
    """One link traversal: ship ``header ++ [extra ++] payload`` along
    ``pattern`` as ONE fused packet (one exchange), batched or not.

    Returns ``(hdr, payload)`` -- plus ``extra`` in the middle when an
    extra section was given.  Pure-local patterns (src == dst for every
    pair) short-circuit: no exchange, mirroring libGalapagos' internal
    routing for same-node kernels.  Non-32-bit payloads cannot bitcast
    onto the int32 wire and ship as separate exchanges, each counted.
    """
    remote = [(s, d) for (s, d) in pattern if s != d]
    if not remote:
        return (hdr, extra, payload) if extra is not None else (hdr, payload)
    if payload is None and extra is None:
        return _permute(ctx, pattern, hdr), None
    if payload is not None and not am.wire_dtype_ok(payload.dtype):
        hdr_r = _permute(ctx, pattern, hdr)
        pay_r = _permute(ctx, pattern, payload)
        if extra is None:
            return hdr_r, pay_r
        return hdr_r, _permute(ctx, pattern, extra), pay_r
    n_extra = 0 if extra is None else extra.shape[-1]
    dtype = torch.int32 if payload is None else payload.dtype
    pkt_r = _permute(ctx, pattern, am.pack_packet(hdr, payload, extra))
    out = am.unpack_packet(pkt_r, dtype, n_extra)
    if payload is None and extra is not None:
        return out[0], out[1], None
    return out


def _mask_nonparticipants(ctx: ShoalContext, pattern: Pattern,
                          hdr: torch.Tensor) -> torch.Tensor:
    sender = _is_sender(ctx, pattern).reshape(
        (ctx.num_kernels,) + (1,) * (hdr.dim() - 1))
    return torch.where(sender, hdr, 0)


def _deliver_reply(ctx: ShoalContext, state: PgasState, pattern: Pattern,
                   hdr_at_dst: am.Header, *, asynchronous: bool = False,
                   token=0, reply_via=None) -> PgasState:
    """Ship the auto-reply back along the reversed pattern and absorb it.

    For batched >MTU plans this runs once with the *final* segment's
    header -- the only acked one -- so a whole message costs one reply.
    Statically-async messages ship nothing.  When ``reply_via`` (a
    :class:`repro_torch.actors.ReplyMailbox`) is given, the reply is
    deferred instead of shipped: the mailbox records one owed credit
    for ``(pattern, token)`` and its flush returns all owed credits for
    a destination as ONE coalesced Short AM."""
    if not ctx.transport.acked or asynchronous:
        return state
    if reply_via is not None:
        reply_via.note(pattern, token)
        return state
    rep = gc.auto_reply(hdr_at_dst)
    rep_back, _ = _exchange(ctx, _reverse(pattern), rep, None)
    return gc.ingress_reply(state, am.decode(rep_back))


def _segments(nwords: int, limit: int):
    """Static segmentation plan: [(offset, words), ...]."""
    if nwords <= limit:
        return [(0, nwords)]
    out, off = [], 0
    while off < nwords:
        w = min(limit, nwords - off)
        out.append((off, w))
        off += w
    return out


def _resolve_nwords(ctx: ShoalContext, payload, from_segment_addr, nwords,
                    op_name: str) -> int:
    """Validate the two calling conventions and return the message size
    (words per kernel)."""
    if payload is not None:
        if payload.dim() < 1 or payload.shape[0] != ctx.num_kernels:
            raise ValueError(
                f"{op_name}: payload must be (K={ctx.num_kernels}, ...), "
                f"got {tuple(payload.shape)}")
        return int(payload[0].numel())
    if from_segment_addr is None or nwords is None:
        raise ValueError(
            f"{op_name}: pass either `payload` (FIFO variant: data from "
            "the kernel) or `from_segment_addr` AND `nwords` "
            "(memory-sourced variant: data read from the local segment)")
    return int(nwords)


def _seg_types(ctx: ShoalContext, msg_class: int, nseg: int, *,
               asynchronous: bool, defer_ack: bool = False, **flags):
    """Per-segment type words: every segment but the last is async, so
    an acked message triggers exactly one (coalesced) reply.  With
    ``defer_ack`` the final segment asks the receiver to ledger that one
    ack for a later packet's piggyback lane instead of replying."""
    t_last = am.make_type(msg_class, asynchronous=asynchronous,
                          defer_ack=defer_ack, **flags)
    t_tail = am.make_type(msg_class, asynchronous=True, **flags)
    if nseg == 1:
        return t_last
    types = torch.full((nseg,), t_tail, dtype=torch.int32, device=ctx.device)
    types[-1] = t_last
    return types


def _check_ack_lanes(op: str, ctx: ShoalContext, *, asynchronous,
                     defer_ack, piggyback_token, reply_via=None) -> None:
    """Validation of the deferred-ack / piggyback / reply_via arguments."""
    if defer_ack:
        if asynchronous:
            raise ValueError(
                f"{op}: defer_ack defers the ack of an *acked* message; "
                "asynchronous=True has no ack to defer")
        if not ctx.transport.acked:
            raise ValueError(
                f"{op}: defer_ack needs an acked transport — this "
                "transport never replies, so there is no ack to defer")
        if reply_via is not None:
            raise ValueError(
                f"{op}: defer_ack (receiver-side ledger) and reply_via "
                "(sender-side reply mailbox) are two different deferred-"
                "ack mechanisms; pick one")
    if piggyback_token is not None:
        if static_int(piggyback_token) is None:
            raise ValueError(
                f"{op}: piggyback_token must be one int for all kernels "
                "(it names a ledger slot)")
        if not 0 <= int(piggyback_token) < hd.NUM_TOKENS:
            raise ValueError(
                f"{op}: piggyback_token {int(piggyback_token)} outside "
                f"[0, {hd.NUM_TOKENS})")


# header column indices used when patching encoded rows in place
_I_TYPE = am.FIELDS.index("type")
_I_TOKEN = am.FIELDS.index("token")
_I_PB_TOKEN = am.FIELDS.index("pb_token")
_I_PB_COUNT = am.FIELDS.index("pb_count")
_I_EPOCH = am.FIELDS.index("epoch")


def _attach_piggyback(ctx: ShoalContext, state: PgasState, pattern: Pattern,
                      hdrs: torch.Tensor, pb_token):
    """Load every sender's deferred-ack ledger for ``pb_token`` into the
    final row's piggyback lane and zero the senders' ledger slot.

    Must run BEFORE :func:`_mask_nonparticipants`: non-senders' rows are
    zeroed afterwards anyway, and their ledger slot is left untouched.
    Returns ``(state, hdrs)``.
    """
    tok = int(pb_token)
    hdrs = hdrs.clone()
    hdrs[:, -1, _I_TYPE] |= am.FLAG_PIGGYBACK
    hdrs[:, -1, _I_PB_TOKEN] = tok
    hdrs[:, -1, _I_PB_COUNT] = state.deferred_acks[:, tok]
    ledger = state.deferred_acks.clone()
    ledger[:, tok] = torch.where(_is_sender(ctx, pattern), 0, ledger[:, tok])
    return replace(state, deferred_acks=ledger), hdrs


def _require_lossless(op: str, ctx: ShoalContext) -> None:
    """Ops without a reliability protocol refuse lossy transports rather
    than pretend the link is perfect (the plain exchange injects no
    faults)."""
    if _transport_is_lossy(ctx.transport):
        raise NotImplementedError(
            f"{op}: no retransmit/dedup protocol on a lossy transport — "
            "only put_long (and wait_replies) defend against loss; use a "
            "lossless transport or route this op over put_long")


# --------------------------------------------------------------------------
# lossy-transport plumbing: sealed + faulted exchanges, bounded retransmit
# --------------------------------------------------------------------------

def _lossy_recv_probs(ctx: ShoalContext, pattern: Pattern) -> torch.Tensor:
    """``(K, 3)`` float32 (drop, dup, corrupt) of every receiver's
    incoming link for one traversal of ``pattern``: each link is
    classified on its own (LOCAL/ICI links stay lossless inside a lossy
    exchange); a kernel that receives nothing gets zeros."""
    tbl = np.zeros((ctx.num_kernels, 3), np.float32)
    for s, d in pattern:
        tbl[d] = ctx.transport.probs_for(s, d)
    return torch.from_numpy(tbl).to(ctx.device)


def _lossy_exchange(ctx: ShoalContext, state: PgasState, pattern: Pattern,
                    pkt: torch.Tensor, dtype: torch.dtype, *, token, epoch,
                    rnd: int, direction: int):
    """One sealed link traversal over a lossy transport.

    ``pkt`` is the fused ``(K, nseg, HDR_WORDS + W)`` int32 stack (``W``
    may be 0 for header-only acks).  The stack is CRC-sealed, shipped,
    faulted receiver-side (:mod:`repro_torch.core.faults`), CRC-checked,
    and rows failing the check are NOPed with ``ERR_CRC`` latched (a
    corrupt packet degenerates to a drop the retransmit loop recovers
    from).  Returns ``(state, hdr_rows, pay_rows)``, the stacks ``(K, 2
    * nseg, ...)`` with duplicate deliveries in the second half.
    """
    pkt = am.seal_packet(pkt)
    remote = [(s, d) for (s, d) in pattern if s != d]
    pkt_r = _permute(ctx, pattern, pkt) if remote else pkt
    probs = _lossy_recv_probs(ctx, pattern)
    draws = ctx.transport.faults.draw(ctx.my_id(), token, epoch, rnd,
                                      direction, pkt.shape[-2],
                                      pkt.shape[-1])
    delivered = flt.deliver(pkt_r, draws, probs[:, 0], probs[:, 1],
                            probs[:, 2])
    ok = am.packet_crc_ok(delivered)
    state = replace(state, error=state.error | torch.where(
        (~ok).any(dim=1), ERR_CRC, 0).to(torch.int32))
    delivered = torch.where(ok[..., None], delivered, 0)
    return (state, delivered[..., :am.HDR_WORDS],
            am.from_wire(delivered[..., am.HDR_WORDS:], dtype))


def _put_long_reliable(ctx: ShoalContext, state: PgasState, pattern: Pattern,
                       hdrs: torch.Tensor, buf: torch.Tensor, W: int,
                       nwords: int, token, *, acked: bool,
                       dedup: bool) -> PgasState:
    """Bounded-retransmit delivery of one sealed Long packet stack.

    Senders re-ship the (NOP-masked, so only still-pending senders pay
    wire words) stack until the receiver's ack survives the reverse
    link, up to ``max_retries`` extra rounds.  Every round runs, as in
    the reference's static program: a sender whose ack came home ships
    NOP rows, and the round's exchanges count all the same (two per
    round when acked).  The per-kernel ``retransmits`` counter records
    the rounds actually re-sent in.  Receivers run the dedup-gated
    ingress so redelivery is idempotent; a completed (or stale-
    redelivered final) row re-acks, covering the lost-ack case.  On
    success the sender grants itself the message's ONE credit on
    ``token``; on exhaustion it latches ``ERR_RETRY_EXHAUSTED`` instead
    and the credit never appears (``wait_replies(..., timeout=True)``
    observes that gracefully).
    """
    K = ctx.num_kernels
    ks = torch.arange(K, device=ctx.device)
    tok_c = torch.as_tensor(token, dtype=torch.int32, device=ctx.device
                            ).expand(K).clamp(0, hd.NUM_TOKENS - 1)
    sender = _is_sender(ctx, pattern)
    epoch = state.send_epoch[ks, tok_c.long()] + 1
    send_epoch = state.send_epoch.clone()
    send_epoch[ks, tok_c.long()] += sender.to(torch.int32)
    state = replace(state, send_epoch=send_epoch)
    hdrs = hdrs.clone()
    hdrs[..., _I_EPOCH] = torch.where(hdrs[..., _I_TYPE] != 0,
                                      epoch[:, None], 0)
    attempts = 1 + (ctx.transport.max_retries if acked else 0)
    pending = sender
    # tx under loss counts FULL wire cost (headers + payload per data
    # round, header-only acks) so goodput = payload / tx_words is honest
    wire = am.wire_words(buf.dtype, nwords) + hdrs.shape[1] * am.HDR_WORDS
    for rnd in range(attempts):
        if rnd:
            state = replace(state, retransmits=state.retransmits
                            + pending.to(torch.int32))
        rows = torch.where(pending[:, None, None], hdrs, 0)
        pay = torch.where(pending[:, None, None], buf, torch.zeros_like(buf))
        state = replace(state, tx_words=state.tx_words + torch.where(
            pending, wire, 0).to(torch.int32))
        state, hdr_r, pay_r = _lossy_exchange(
            ctx, state, pattern, am.pack_packet(rows, pay), buf.dtype,
            token=tok_c, epoch=epoch, rnd=rnd, direction=flt.DIR_DATA)
        state, ack_hdr = gc.ingress_reliable_stack(ctx, state, hdr_r, pay_r,
                                                   W, dedup=dedup)
        if not acked:
            return state
        state = replace(state, tx_words=state.tx_words + torch.where(
            ack_hdr[:, _I_TYPE] != 0, am.HDR_WORDS, 0).to(torch.int32))
        state, rep_r, _ = _lossy_exchange(
            ctx, state, _reverse(pattern), ack_hdr[:, None], torch.int32,
            token=tok_c, epoch=epoch, rnd=rnd, direction=flt.DIR_REPLY)
        t_col = rep_r[..., _I_TYPE]
        got = (((t_col & am._CLASS_MASK) == am.SHORT)
               & ((t_col & am.FLAG_REPLY) != 0)
               & (rep_r[..., _I_TOKEN] == tok_c[:, None])).any(dim=1)
        pending = pending & ~got
    credits = state.credits.clone()
    credits[ks, tok_c.long()] += (sender & ~pending).to(torch.int32)
    return replace(state, credits=credits, error=state.error | torch.where(
        pending, ERR_RETRY_EXHAUSTED, 0).to(torch.int32))


def _count_tx(ctx: ShoalContext, state: PgasState, pattern: Pattern,
              nwords: int) -> PgasState:
    words = am.wire_words(state.segment.dtype, nwords)
    return replace(state, tx_words=state.tx_words + torch.where(
        _is_sender(ctx, pattern), words, 0).to(torch.int32))


def _plan(ctx: ShoalContext, nwords: int, limit: int):
    """``(nseg, W, offsets, words)`` of the :func:`_segments` plan, the
    last two as ``(nseg,)`` int32 tensors made on the context's device
    (every segment but the last is ``W`` words long)."""
    segs = _segments(nwords, limit)
    W = segs[0][1]
    offs = torch.arange(len(segs), dtype=torch.int32, device=ctx.device) * W
    return len(segs), W, offs, (nwords - offs).clamp(max=W)


# --------------------------------------------------------------------------
# Short AMs
# --------------------------------------------------------------------------

def put_short(ctx: ShoalContext, state: PgasState, pattern: Pattern, *,
              handler=hd.H_ADD, arg=1, token=0, asynchronous: bool = False,
              reply_via=None) -> PgasState:
    """Short AM: signal the destination (no payload).

    The handler runs on the destination's credit word ``token`` with
    ``arg``; the default (H_ADD, 1) is a counting semaphore.
    ``reply_via`` defers the ack into a reply mailbox
    (:func:`_deliver_reply`).
    """
    _require_lossless("put_short", ctx)
    tag = None
    if _lint.active():
        h_s, a_s, t_s = (_lint.known_int(handler), _lint.known_int(arg),
                         _lint.known_int(token))
        grants = ((t_s, a_s),) if (h_s == hd.H_ADD and a_s is not None
                                   and t_s is not None) else ()
        tag = _lint.emit(
            "put_short", pattern, token=t_s,
            acked=ctx.transport.acked and not asynchronous,
            asynchronous=asynchronous, deferred_reply=reply_via is not None,
            credit_grants=grants, handler=h_s,
            segment_words=ctx.segment_words)
    with _lint.scope(tag):
        t = am.make_type(am.SHORT, asynchronous=asynchronous)
        hdr = am.encode(type=t, src=ctx.my_id(), dst=_dst_of(ctx, pattern),
                        handler=handler, token=token, dst_addr=arg)
        hdr = _mask_nonparticipants(ctx, pattern, hdr)
        hdr_r, _ = _exchange(ctx, pattern, hdr, None)
        h = am.decode(hdr_r)
        state = gc.ingress_short(ctx, state, h)
        return _deliver_reply(ctx, state, pattern, h,
                              asynchronous=asynchronous, token=token,
                              reply_via=reply_via)


# --------------------------------------------------------------------------
# Medium AMs (payload -> destination kernel)
# --------------------------------------------------------------------------

def put_medium(ctx: ShoalContext, state: PgasState,
               payload: torch.Tensor | None, pattern: Pattern, *,
               handler=hd.H_NOP, token=0, asynchronous: bool = False,
               from_segment_addr=None, nwords: int | None = None,
               reply_via=None):
    """Medium AM: point-to-point payload straight to the destination
    kernel (returned value).  ``from_segment_addr`` selects the
    memory-sourced variant (``nwords`` read from the local segment);
    default is the FIFO variant with ``payload (K, ...)`` from the kernel.

    Returns ``(state, delivered)``; ``delivered (K, nwords)`` is zeros on
    kernels that receive nothing.  >MTU payloads ship as one packet
    stack: a single exchange plus (if acked) a single coalesced reply.
    """
    _require_lossless("put_medium", ctx)
    nwords = _resolve_nwords(ctx, payload, from_segment_addr, nwords,
                             "put_medium")
    fifo = from_segment_addr is None
    tag = _lint.emit(
        "put_medium", pattern, token=_lint.known_int(token),
        acked=ctx.transport.acked and not asynchronous,
        asynchronous=asynchronous, deferred_reply=reply_via is not None,
        handler=_lint.known_int(handler), segment_words=ctx.segment_words,
        detail={"nwords": nwords}) if _lint.active() else None
    with _lint.scope(tag):
        nseg, W, offs, ws = _plan(ctx, nwords,
                                  ctx.transport.max_packet_words)
        hdrs = am.encode_batch(
            nseg,
            type=_seg_types(ctx, am.MEDIUM, nseg, asynchronous=asynchronous,
                            fifo=fifo),
            src=_col(ctx.my_id()), dst=_col(_dst_of(ctx, pattern)),
            nwords=ws, handler=_col(handler), token=_col(token),
            src_addr=0 if fifo else _col(from_segment_addr) + offs,
            seq=offs)
        hdrs = _mask_nonparticipants(ctx, pattern, hdrs)
        buf = gc.egress_batch(ctx, state, hdrs, payload if fifo else None, W)
        state = _count_tx(ctx, state, pattern, nwords)
        hdr_r, pay_r = _exchange(ctx, pattern, hdrs, buf)
        state, delivered = gc.ingress_medium_batch(state, hdr_r, pay_r, W)
        state = _deliver_reply(ctx, state, pattern, am.decode(hdr_r[:, -1]),
                               asynchronous=asynchronous, token=token,
                               reply_via=reply_via)
        return state, delivered[:, :nwords]


# --------------------------------------------------------------------------
# Long AMs (payload -> destination shared memory)
# --------------------------------------------------------------------------

def put_long(ctx: ShoalContext, state: PgasState,
             payload: torch.Tensor | None, pattern: Pattern, dst_addr, *,
             handler=hd.H_WRITE, token=0, asynchronous: bool = False,
             from_segment_addr=None, nwords: int | None = None,
             reply_via=None, defer_ack: bool = False, piggyback_token=None,
             dedup: bool = True) -> PgasState:
    """Long AM: one-sided put into the destination kernel's segment at
    ``dst_addr``, applied through ``handler`` (H_WRITE = plain put,
    H_ADD = remote accumulate, ...).  FIFO variant when ``payload`` is
    given; memory-sourced variant when ``from_segment_addr`` is.

    >MTU payloads ship as one ``(K, nseg, HDR+W)`` packet stack -- a
    single exchange -- absorbed in row order; an acked message earns ONE
    credit (the final segment carries the ack).

    ``defer_ack=True`` removes even the reply exchange: the receiver
    ledgers the owed ack (``state.deferred_acks[token]``) and a later
    packet crossing the reverse link carries it home -- another put with
    ``piggyback_token=token`` or :func:`drain_deferred_acks`.
    ``piggyback_token=t`` loads THIS packet's piggyback lane with the
    sender's ledgered acks for ``t``.  ``reply_via`` defers the ack into
    a reply mailbox instead (:func:`_deliver_reply`).

    On a lossy transport (a :class:`~repro_torch.runtime.transport.
    LossyTransport` with a non-zero fault model) the put runs the
    reliability protocol instead: packets are CRC-sealed and
    epoch-stamped, receivers dedup redelivery, and (if acked) senders
    retransmit up to ``max_retries`` rounds before latching
    ``ERR_RETRY_EXHAUSTED`` -- see :func:`_put_long_reliable`.
    ``dedup=False`` disables the receiver ledger.  The ack-lane
    machinery (defer_ack / piggyback / reply_via) presumes a lossless
    reply and is refused on lossy transports.
    """
    nwords = _resolve_nwords(ctx, payload, from_segment_addr, nwords,
                             "put_long")
    fifo = from_segment_addr is None
    _check_ack_lanes("put_long", ctx, asynchronous=asynchronous,
                     defer_ack=defer_ack, piggyback_token=piggyback_token,
                     reply_via=reply_via)
    lossy = _transport_is_lossy(ctx.transport)
    if lossy and (defer_ack or piggyback_token is not None
                  or reply_via is not None):
        raise NotImplementedError(
            "put_long: deferred/piggybacked acks assume a lossless reply "
            "path and cannot ride a lossy transport (a dropped piggyback "
            "lane would strand the ledger); use plain acked puts")
    acked = ctx.transport.acked and not asynchronous
    tag = _lint.emit(
        "put_long", pattern,
        writes=(Interval(_lint.known_int(dst_addr), nwords),),
        token=_lint.known_int(token), acked=acked,
        asynchronous=asynchronous, deferred_reply=reply_via is not None,
        defer_ack=defer_ack,
        piggyback_token=(None if piggyback_token is None
                         else static_int(piggyback_token)),
        handler=_lint.known_int(handler), segment_words=ctx.segment_words,
        lossy=lossy,
        retries=(ctx.transport.max_retries if lossy and acked else 0),
        dedup=dedup if lossy else True) if _lint.active() else None
    with _lint.scope(tag):
        nseg, W, offs, ws = _plan(ctx, nwords,
                                  ctx.transport.max_packet_words)
        if lossy and nseg > 31:
            raise NotImplementedError(
                f"put_long: {nseg} segments > 31 — the dedup ledger's "
                "arrival bitmask is one int32 per token; raise the MTU or "
                "split the message")
        hdrs = am.encode_batch(
            nseg,
            type=_seg_types(ctx, am.LONG, nseg, asynchronous=asynchronous,
                            defer_ack=defer_ack, fifo=fifo),
            src=_col(ctx.my_id()), dst=_col(_dst_of(ctx, pattern)),
            nwords=ws, dst_addr=_col(dst_addr) + offs,
            src_addr=0 if fifo else _col(from_segment_addr) + offs,
            handler=_col(handler), token=_col(token), seq=offs)
        if piggyback_token is not None:
            state, hdrs = _attach_piggyback(ctx, state, pattern, hdrs,
                                            piggyback_token)
        hdrs = _mask_nonparticipants(ctx, pattern, hdrs)
        buf = gc.egress_batch(ctx, state, hdrs, payload if fifo else None, W)
        if lossy:
            if not am.wire_dtype_ok(buf.dtype):
                raise NotImplementedError(
                    "put_long: the lossy-transport seal covers the fused "
                    "int32 packet; sub-32-bit payloads use the split "
                    "fallback and have no integrity protection yet")
            return _put_long_reliable(ctx, state, pattern, hdrs, buf, W,
                                      nwords, token, acked=acked,
                                      dedup=dedup)
        state = _count_tx(ctx, state, pattern, nwords)
        hdr_r, pay_r = _exchange(ctx, pattern, hdrs, buf)
        state = gc.ingress_long_batch(ctx, state, hdr_r, pay_r, W)
        # the final row is the only non-async one: it carries the ack
        # lanes (defer ledger bump and/or piggybacked ack grant)
        last = am.decode(hdr_r[:, -1])
        state = gc.ingress_ack_lanes(state, last)
        return _deliver_reply(ctx, state, pattern, last,
                              asynchronous=asynchronous or defer_ack,
                              token=token, reply_via=reply_via)


def group_disjoint_patterns(patterns: list[Pattern]) -> list[list[int]]:
    """Greedily group patterns into valid union permutations.

    Two patterns may share one exchange only when BOTH their source sets
    and their destination sets are disjoint (each kernel sends at most
    one packet and receives at most one).  Disjoint rings (even->odd and
    odd->even) merge; Jacobi's up/down halo pair does not (every
    interior kernel sends on both links), which is why its steady state
    needs reply piggybacking rather than more merging.  Returns index
    lists into ``patterns``, first-fit in input order.
    """
    groups: list[list[int]] = []
    gsrcs: list[set[int]] = []
    gdsts: list[set[int]] = []
    for i, pat in enumerate(patterns):
        srcs = {s for s, _ in pat}
        dsts = {d for _, d in pat}
        for g in range(len(groups)):
            if not (gsrcs[g] & srcs) and not (gdsts[g] & dsts):
                groups[g].append(i)
                gsrcs[g] |= srcs
                gdsts[g] |= dsts
                break
        else:
            groups.append([i])
            gsrcs.append(set(srcs))
            gdsts.append(set(dsts))
    return groups


def _counted_group_reply(ctx: ShoalContext, state: PgasState,
                         union: Pattern, hdr_r: torch.Tensor, *, token=None,
                         classes: tuple[int, ...] | None = (am.LONG,)
                         ) -> PgasState:
    """ONE reply exchange for a whole grouped packet stack.

    Each receiver counts the acked rows it just absorbed (non-async,
    non-reply, non-deferred -- one per message) and ships the count back
    as a Short H_ADD over the reversed union.  A receiver got rows from
    at most one sender, so the token read off its acked rows is
    single-valued; a given ``token`` overrides it.  ``classes``
    restricts which message classes count (``None`` = any non-NOP row).
    """
    t_col = hdr_r[..., _I_TYPE]
    cls = t_col & am._CLASS_MASK
    if classes is None:
        is_cls = cls != am.NOP
    else:
        is_cls = torch.zeros_like(t_col, dtype=torch.bool)
        for c in classes:
            is_cls = is_cls | (cls == c)
    needs = is_cls & ((t_col & (am.FLAG_ASYNC | am.FLAG_REPLY
                                | am.FLAG_DEFER_ACK)) == 0)
    cnt = needs.sum(dim=1, dtype=torch.int32)
    tok = (torch.where(needs, hdr_r[..., _I_TOKEN], 0).amax(dim=1)
           if token is None else token)
    rev = _reverse(union)
    hdr = am.encode(type=am.make_type(am.SHORT, asynchronous=True),
                    src=ctx.my_id(), dst=_dst_of(ctx, rev),
                    handler=hd.H_ADD, token=tok, dst_addr=cnt)
    hdr = _mask_nonparticipants(ctx, rev, hdr)
    hdr_back, _ = _exchange(ctx, rev, hdr, None)
    return gc.ingress_short(ctx, state, am.decode(hdr_back))


def put_long_multi(ctx: ShoalContext, state: PgasState, items, *,
                   handler=hd.H_WRITE, token=0, tokens=None,
                   asynchronous: bool = False, defer_ack: bool = False,
                   piggyback_tokens=None, reply_via=None) -> PgasState:
    """Multi-destination Long put: batch several puts over different
    patterns into as few exchanges as possible.

    ``items`` is ``[(payload (K, ...), pattern, dst_addr), ...]`` (FIFO
    variant).  Patterns whose source AND destination sets are disjoint
    form a valid union permutation: their packet stacks concatenate and
    the whole group crosses the links as ONE exchange, absorbed by
    :func:`repro_torch.core.gascore.ingress_stack`.  Patterns that share
    a source or destination land in separate groups
    (:func:`group_disjoint_patterns`).

    Ack accounting: one credit per item, on that item's token.  On the
    immediate-ack path each group costs ONE extra reply exchange
    (:func:`_counted_group_reply`); with ``reply_via`` every item's ack
    is noted in the reply mailbox instead.  With ``defer_ack=True`` there is no
    reply exchange: receivers ledger the acks and
    ``piggyback_tokens[i]`` loads item *i*'s final packet with the
    sender's ledgered acks for that token.

    Destination intervals that overlap across items sharing a
    destination kernel raise :class:`VectoredAliasError` -- the landed
    value would depend on stack order -- unless the call is wrapped in
    ``repro_torch.analysis.waiver(reason)``.  Items that share a
    destination kernel never share a group, so a waived call lands them
    in item order.
    """
    if not items:
        raise ValueError("put_long_multi: empty item list")
    _require_lossless("put_long_multi", ctx)
    k = len(items)
    toks = list(tokens) if tokens is not None else [token] * k
    if len(toks) != k:
        raise ValueError(f"put_long_multi: {k} items but {len(toks)} tokens")
    pbs = (list(piggyback_tokens) if piggyback_tokens is not None
           else [None] * k)
    if len(pbs) != k:
        raise ValueError(
            f"put_long_multi: {k} items but {len(pbs)} piggyback_tokens")
    for pb in pbs:
        _check_ack_lanes("put_long_multi", ctx, asynchronous=asynchronous,
                         defer_ack=defer_ack, piggyback_token=pb,
                         reply_via=reply_via)
    parsed = []
    for i, item in enumerate(items):
        try:
            payload, pattern, dst_addr = item
        except (TypeError, ValueError):
            raise ValueError(
                "put_long_multi: items are (payload, pattern, dst_addr) "
                f"triples; item {i} is {item!r}") from None
        if payload is None:
            raise ValueError(
                f"put_long_multi: item {i} has no payload (only the "
                "FIFO variant batches; use put_long for memory-sourced)")
        pat = [(int(s), int(d)) for s, d in pattern]
        nw = _resolve_nwords(ctx, payload, None, None, "put_long_multi")
        parsed.append((payload, pat, dst_addr, nw))
    ivs = [Interval(_lint.known_int(a), nw) for _, _, a, nw in parsed]
    alias = None
    for i in range(k):
        for j in range(i + 1, k):
            common = ({d for _, d in parsed[i][1]}
                      & {d for _, d in parsed[j][1]})
            if common and ivs[i].known and ivs[j].known \
                    and ivs[i].overlaps(ivs[j]):
                alias = (i, j, sorted(common))
                break
        if alias:
            break
    if alias is not None and _lint.current_waiver() is None:
        i, j, common = alias
        raise VectoredAliasError(
            f"put_long_multi: items {i} ({ivs[i]}) and {j} ({ivs[j]}) "
            f"overlap at destination kernel(s) {common} within one "
            "batched call, so the landed value depends on stack order "
            "(silent last-writer-wins). Give the items disjoint "
            "intervals, or wrap the call in "
            "repro_torch.analysis.waiver(reason) if the overlap is "
            "deliberate.")
    groups = group_disjoint_patterns([p for _, p, _, _ in parsed])
    acked = ctx.transport.acked and not asynchronous
    mtu = ctx.transport.max_packet_words
    me = _col(ctx.my_id())
    for gi, grp in enumerate(groups):
        # one packet width for the whole group so stacks concatenate
        W = min(mtu, max(parsed[i][3] for i in grp))
        group_tag = None
        hdr_rows, pay_rows, union = [], [], []
        for i in grp:
            payload, pat, dst_addr, nw = parsed[i]
            tag = _lint.emit(
                "put_long_multi", pat, writes=(ivs[i],),
                token=_lint.known_int(toks[i]), acked=acked,
                asynchronous=asynchronous,
                deferred_reply=reply_via is not None, defer_ack=defer_ack,
                piggyback_token=None if pbs[i] is None else static_int(pbs[i]),
                handler=_lint.known_int(handler),
                segment_words=ctx.segment_words,
                self_overlap=alias is not None and i in alias[:2],
                detail={"group": gi, "item": i, "n_items": k}
            ) if _lint.active() else None
            group_tag = group_tag or tag
            union.extend(pat)
            with _lint.scope(tag):
                nseg, _, offs, ws = _plan(ctx, nw, W)
                hdrs = am.encode_batch(
                    nseg,
                    type=_seg_types(ctx, am.LONG, nseg,
                                    asynchronous=asynchronous,
                                    defer_ack=defer_ack, fifo=True),
                    src=me, dst=_col(_dst_of(ctx, pat)), nwords=ws,
                    dst_addr=_col(dst_addr) + offs, handler=_col(handler),
                    token=_col(toks[i]), seq=offs)
                if pbs[i] is not None:
                    state, hdrs = _attach_piggyback(ctx, state, pat, hdrs,
                                                    pbs[i])
                hdrs = _mask_nonparticipants(ctx, pat, hdrs)
                pay_rows.append(gc.egress_batch(ctx, state, hdrs, payload,
                                                W))
                hdr_rows.append(hdrs)
                state = _count_tx(ctx, state, pat, nw)
        union = sorted(set(union))
        with _lint.scope(group_tag):
            hdr_r, pay_r = _exchange(ctx, union, torch.cat(hdr_rows, dim=1),
                                     torch.cat(pay_rows, dim=1))
            # Long rows only: every credit update adds
            state = gc.ingress_stack(ctx, state, hdr_r, pay_r, W,
                                     additive=True)
            if acked and not defer_ack:
                if reply_via is not None:
                    for i in grp:
                        reply_via.note(parsed[i][1], toks[i])
                else:
                    state = _counted_group_reply(ctx, state, union, hdr_r)
    return state


def drain_deferred_acks(ctx: ShoalContext, state: PgasState,
                        pattern: Pattern, token) -> PgasState:
    """Ship every kernel's residual deferred-ack ledger for ``token``
    home as one header-only Short H_ADD along ``pattern`` (1 exchange)
    and zero the ledger slot.

    Loop exit for the piggyback protocol: the final iteration's acks are
    still ledgered at the receivers.  ``pattern`` is the REVERSE link of
    the defer-acked puts.  The count rides in the handler-arg word, so
    one drain balances any number of outstanding puts.
    """
    _require_lossless("drain_deferred_acks", ctx)
    t_s = static_int(token)
    if t_s is None:
        raise ValueError("drain_deferred_acks: token must be one int for "
                         "all kernels (it names the ledger slot)")
    if not 0 <= t_s < hd.NUM_TOKENS:
        raise ValueError(
            f"drain_deferred_acks: token {t_s} outside [0, {hd.NUM_TOKENS})")
    tag = _lint.emit("drain_deferred_acks", pattern, token=t_s,
                     acked=False, asynchronous=True, drains_deferred=True,
                     handler=hd.H_ADD, segment_words=ctx.segment_words
                     ) if _lint.active() else None
    with _lint.scope(tag):
        hdr = am.encode(type=am.make_type(am.SHORT, asynchronous=True),
                        src=ctx.my_id(), dst=_dst_of(ctx, pattern),
                        handler=hd.H_ADD, token=t_s,
                        dst_addr=state.deferred_acks[:, t_s])
        hdr = _mask_nonparticipants(ctx, pattern, hdr)
        ledger = state.deferred_acks.clone()
        ledger[:, t_s] = torch.where(_is_sender(ctx, pattern), 0,
                                     ledger[:, t_s])
        state = replace(state, deferred_acks=ledger)
        hdr_r, _ = _exchange(ctx, pattern, hdr, None)
        return gc.ingress_short(ctx, state, am.decode(hdr_r))


def _strides_may_overlap(stride, blk_words: int, nblocks: int) -> bool:
    """Overlap detection for strided puts: True when consecutive blocks
    can alias (``|stride| < blk_words``).  A per-kernel (tensor) stride
    is conservatively treated as overlapping -- the caller can override
    with the ``overlap`` keyword when it knows better."""
    if nblocks <= 1:
        return False
    s = _lint.known_int(stride)
    return True if s is None else abs(s) < blk_words


def put_long_strided(ctx: ShoalContext, state: PgasState,
                     payload: torch.Tensor, pattern: Pattern, dst_addr,
                     stride, *, blk_words: int, nblocks: int,
                     handler=hd.H_WRITE, token=0,
                     asynchronous: bool = False,
                     overlap: bool | None = None,
                     reply_via=None) -> PgasState:
    """Strided Long put: ``nblocks`` blocks of ``blk_words`` land at
    ``dst_addr + i*stride`` (THeGASNet's strided access, carried forward
    by the paper).  ``payload`` is the packed ``(K, nblocks*blk_words)``
    buffer.  >MTU messages segment at block granularity into one packet
    stack (single exchange, one coalesced reply).

    The DataMover scatter lands blocks in order, so aliasing strides
    (``|stride| < blk_words``) get last-writer-wins and correct
    read-modify-write handlers whatever ``overlap`` says.  ``overlap``
    (default: the detection of :func:`_strides_may_overlap`) selects
    the reference's ingress -- ``True`` its block-sequential one,
    ``False`` its unordered vectorized one -- and changes only the
    recorded comm event (``ordered_ingress``, ``self_overlap``: lint rule
    R1 flags aliasing blocks on the unordered ingress), never the landed
    bits.
    """
    _require_lossless("put_long_strided", ctx)
    ordered = (_strides_may_overlap(stride, blk_words, nblocks)
               if overlap is None else bool(overlap))
    nwords = blk_words * nblocks
    tag = None
    if _lint.active():
        base_s, stride_s = _lint.known_int(dst_addr), _lint.known_int(stride)
        if base_s is not None and stride_s is not None:
            w_ivs = tuple(Interval(base_s + i * stride_s, blk_words)
                          for i in range(nblocks))
        else:
            w_ivs = (Interval(None, nwords),)
        may_alias = _strides_may_overlap(stride, blk_words, nblocks)
        tag = _lint.emit(
            "put_long_strided", pattern, writes=w_ivs,
            token=_lint.known_int(token),
            acked=ctx.transport.acked and not asynchronous,
            asynchronous=asynchronous, deferred_reply=reply_via is not None,
            handler=_lint.known_int(handler),
            segment_words=ctx.segment_words, ordered_ingress=ordered,
            self_overlap=may_alias and not ordered,
            detail={"stride": stride_s, "blk_words": blk_words,
                    "nblocks": nblocks})
    with _lint.scope(tag):
        # blocks per packet; >MTU plans segment at block granularity
        per = max(1, ctx.transport.max_packet_words // blk_words)
        nseg = -(-nblocks // per)
        W = min(per, nblocks) * blk_words
        segi = torch.arange(nseg, dtype=torch.int32, device=ctx.device)
        nb = (nblocks - per * segi).clamp(max=per)
        hdrs = am.encode_batch(
            nseg,
            type=_seg_types(ctx, am.LONG, nseg, asynchronous=asynchronous,
                            fifo=True, strided=True),
            src=_col(ctx.my_id()), dst=_col(_dst_of(ctx, pattern)),
            nwords=nb * blk_words,
            dst_addr=_col(dst_addr) + segi * per * _col(stride),
            handler=_col(handler), token=_col(token), stride=_col(stride),
            blk_words=blk_words, nblocks=nb, seq=segi * (per * blk_words))
        hdrs = _mask_nonparticipants(ctx, pattern, hdrs)
        buf = gc.egress_batch(ctx, state, hdrs, payload, W)
        state = _count_tx(ctx, state, pattern, nwords)
        hdr_r, pay_r = _exchange(ctx, pattern, hdrs, buf)
        state = gc.ingress_strided_batch(ctx, state, hdr_r, pay_r, blk_words,
                                         min(per, nblocks), ordered)
        return _deliver_reply(ctx, state, pattern, am.decode(hdr_r[:, -1]),
                              asynchronous=asynchronous, token=token,
                              reply_via=reply_via)


def put_long_vectored(ctx: ShoalContext, state: PgasState,
                      blocks: list[torch.Tensor], pattern: Pattern,
                      dst_addrs, *, handler=hd.H_WRITE, token=0,
                      asynchronous: bool = False,
                      reply_via=None) -> PgasState:
    """Vectored Long put: ``blocks[i]`` (``(K, w_i)``) lands at
    ``dst_addrs[i]`` (an int or a ``(K,)`` tensor; or pass a ``(K, B)``
    tensor).  One AM on the wire: the destination address list rides
    inside the fused packet as an extra int32 section (``header ++
    addrs ++ payload``), so the whole message is a single exchange; the
    receiver lands the blocks as the ``B`` rows of one DataMover scatter
    (per-row ``nwords`` and ``dst_addr``), in block order.  Vectored
    puts do not segment.  Blocks whose known destination intervals
    overlap raise :class:`VectoredAliasError`, unless the call is
    wrapped in ``repro_torch.analysis.waiver(reason)``: then the packet
    ships, lands in block order (the later block wins where they meet),
    and the hazard is recorded as a waived lint finding (R4)."""
    _require_lossless("put_long_vectored", ctx)
    K = ctx.num_kernels
    if torch.is_tensor(dst_addrs):
        addrs = dst_addrs.to(device=ctx.device, dtype=torch.int32)
        if addrs.dim() == 1:
            addrs = addrs.expand(K, -1)
        n_addrs = addrs.shape[-1]
        host_addrs = [None] * n_addrs
    else:
        n_addrs = len(dst_addrs)
        host_addrs = dst_addrs
    if n_addrs != len(blocks):
        raise ValueError(
            f"put_long_vectored: {len(blocks)} blocks but {n_addrs} "
            "dst_addrs — one destination address per block")
    sizes = [_resolve_nwords(ctx, b, None, None, "put_long_vectored")
             for b in blocks]
    nwords = sum(sizes)
    if nwords + len(blocks) > ctx.transport.max_packet_words:
        raise ValueError(
            f"put_long_vectored: {nwords} payload words + {len(blocks)} "
            f"in-packet addresses exceed the transport MTU "
            f"({ctx.transport.max_packet_words} words); vectored puts do "
            "not segment — split the block list across messages")
    ivs = _lint.intervals_for_blocks(host_addrs, sizes)
    alias = next(((i, j) for i in range(len(ivs))
                  for j in range(i + 1, len(ivs))
                  if ivs[i].known and ivs[j].known
                  and ivs[i].overlaps(ivs[j])), None)
    if alias is not None and _lint.current_waiver() is None:
        i, j = alias
        raise VectoredAliasError(
            f"put_long_vectored: destination blocks {i} ({ivs[i]}) and "
            f"{j} ({ivs[j]}) overlap inside one packet, so the landed "
            "value depends on the receiver's scatter order (duplicate "
            "addresses are the degenerate case). Give each block a "
            "disjoint interval, or wrap the call in "
            "repro_torch.analysis.waiver(reason) if the overlap is "
            "deliberate.")
    tag = _lint.emit(
        "put_long_vectored", pattern, writes=ivs,
        token=_lint.known_int(token),
        acked=ctx.transport.acked and not asynchronous,
        asynchronous=asynchronous, deferred_reply=reply_via is not None,
        handler=_lint.known_int(handler), segment_words=ctx.segment_words,
        self_overlap=alias is not None,
        detail={} if alias is None else
        {"alias": f"blocks {alias[0]} and {alias[1]} overlap"}
    ) if _lint.active() else None
    with _lint.scope(tag):
        if not torch.is_tensor(dst_addrs):
            addrs = torch.stack([torch.as_tensor(a, dtype=torch.int32,
                                                 device=ctx.device).expand(K)
                                 for a in dst_addrs], dim=1)
        payload = torch.cat([b.reshape(K, -1) for b in blocks], dim=1)
        t = am.make_type(am.LONG, asynchronous=asynchronous, fifo=True,
                         vectored=True)
        hdr = am.encode(type=t, src=ctx.my_id(), dst=_dst_of(ctx, pattern),
                        nwords=nwords, handler=handler, token=token,
                        nblocks=len(blocks))
        hdr = _mask_nonparticipants(ctx, pattern, hdr)
        buf = gc.egress(ctx, state, am.decode(hdr), payload, nwords)
        state = _count_tx(ctx, state, pattern, nwords)
        hdr_r, addrs_r, pay_r = _exchange(ctx, pattern, hdr, buf,
                                          extra=addrs)
        h = am.decode(hdr_r)
        state = gc.ingress_vectored(ctx, state, h, addrs_r, pay_r, sizes)
        return _deliver_reply(ctx, state, pattern, h,
                              asynchronous=asynchronous, token=token,
                              reply_via=reply_via)


# --------------------------------------------------------------------------
# Gets (one round trip: request header out, data back)
# --------------------------------------------------------------------------

def _get_round_trip(ctx: ShoalContext, state: PgasState, pattern: Pattern,
                    hdrs: torch.Tensor, W: int):
    hdrs = _mask_nonparticipants(ctx, pattern, hdrs)
    hdr_r, _ = _exchange(ctx, pattern, hdrs, None)
    state, resp_rows, data_rows = gc.serve_get_batch(ctx, state, hdr_r, W)
    back_hdr, back_data = _exchange(ctx, _reverse(pattern), resp_rows,
                                    data_rows)
    state = gc.ingress_reply(state, am.decode(back_hdr[:, -1]))
    return state, back_hdr, back_data


def get_medium(ctx: ShoalContext, state: PgasState, pattern: Pattern,
               src_addr, nwords: int, *, token=0):
    """Medium get: fetch ``nwords`` at ``src_addr`` in the *destination*
    kernel's segment, delivered to the requesting kernel.  Returns
    ``(state, data (K, nwords))``.  The data return doubles as the reply
    (credits bump ONCE per message, on the final segment).  >MTU gets
    batch all request headers into one exchange and the whole response
    into a second: 2 link traversals regardless of segment count."""
    _require_lossless("get_medium", ctx)
    tag = _lint.emit(
        "get_medium", pattern,
        reads=(Interval(_lint.known_int(src_addr), int(nwords)),),
        token=_lint.known_int(token), acked=True,
        segment_words=ctx.segment_words) if _lint.active() else None
    with _lint.scope(tag):
        nseg, W, offs, ws = _plan(ctx, nwords,
                                  ctx.transport.max_packet_words)
        hdrs = am.encode_batch(
            nseg, type=am.make_type(am.MEDIUM, get=True),
            src=_col(ctx.my_id()), dst=_col(_dst_of(ctx, pattern)),
            nwords=ws, src_addr=_col(src_addr) + offs, token=_col(token),
            seq=offs)
        state, back_hdr, back_data = _get_round_trip(ctx, state, pattern,
                                                     hdrs, W)
        state, data = gc.ingress_medium_batch(state, back_hdr, back_data, W)
        return state, data[:, :nwords]


def get_long(ctx: ShoalContext, state: PgasState, pattern: Pattern,
             src_addr, nwords: int, dst_addr, *, handler=hd.H_WRITE,
             token=0) -> PgasState:
    """Long get: fetch remote segment words into the *local* segment at
    ``dst_addr`` (one-sided read).  Same 2-traversal wire plan as
    :func:`get_medium`; one credit per message."""
    _require_lossless("get_long", ctx)
    tag = _lint.emit(
        "get_long", pattern,
        reads=(Interval(_lint.known_int(src_addr), int(nwords)),),
        token=_lint.known_int(token), acked=True,
        handler=_lint.known_int(handler), segment_words=ctx.segment_words,
        detail={"local_dst_addr": _lint.known_int(dst_addr)}
    ) if _lint.active() else None
    with _lint.scope(tag):
        nseg, W, offs, ws = _plan(ctx, nwords,
                                  ctx.transport.max_packet_words)
        hdrs = am.encode_batch(
            nseg, type=am.make_type(am.LONG, get=True),
            src=_col(ctx.my_id()), dst=_col(_dst_of(ctx, pattern)),
            nwords=ws, src_addr=_col(src_addr) + offs,
            dst_addr=_col(dst_addr) + offs, token=_col(token),
            handler=_col(handler), seq=offs)
        state, back_hdr, back_data = _get_round_trip(ctx, state, pattern,
                                                     hdrs, W)
        # land in the local segment through the handler (class LONG)
        land = back_hdr.clone()
        land[..., _I_TYPE] = torch.where(
            (back_hdr[..., _I_TYPE] & am.FLAG_REPLY) != 0, am.LONG, am.NOP)
        return gc.ingress_long_batch(ctx, state, land, back_data, W)


# --------------------------------------------------------------------------
# synchronization
# --------------------------------------------------------------------------

def barrier(ctx: ShoalContext, state: PgasState) -> PgasState:
    """Global barrier over all kernels (paper Sec. III: "barriers for
    synchronization").  Every kernel's step is one program over the
    kernel axis, so all kernels have arrived when it runs; the barrier
    epoch counts completions.  It is no link traversal (the reference's
    barrier is a reduction, not a permute) and bumps no exchange."""
    if _lint.active():
        _lint.emit("barrier", [])
    return replace(state, barrier_epoch=state.barrier_epoch + 1)


def wait_replies(ctx: ShoalContext, state: PgasState, token, n, *,
                 timeout: bool = False) -> PgasState:
    """Wait for ``n`` replies on ``token`` then consume them.

    Replies coalesce across >MTU segmentation, so ``n`` counts
    *messages*, not packets.  Arrival is guaranteed by data dependence,
    so this is bookkeeping: it drains ``n`` credits and latches the
    sticky ``ERR_WAIT_UNDERFLOW`` bit if fewer than ``n`` were present
    -- the observable equivalent of a hang in the threaded original.
    ``timeout=True`` drains ``min(have, n)`` and latches nothing.
    ``token`` and ``n`` are ints or ``(K,)`` tensors.
    """
    if _lint.active():
        _lint.emit("wait_replies", [], token=_lint.known_int(token),
                   wait_n=_lint.known_int(n), timeout=timeout)
    if torch.is_tensor(token):
        token = token.clamp(0, hd.NUM_TOKENS - 1)
        have = state.credits[torch.arange(ctx.num_kernels,
                                          device=token.device),
                             token.long()]
    else:
        token = min(max(int(token), 0), hd.NUM_TOKENS - 1)
        have = state.credits[:, token]
    if timeout:
        take = (torch.minimum(have, n) if torch.is_tensor(n)
                else have.clamp(max=n)).clamp(min=0)
        return replace(state, credits=hd.drain_credits(state.credits, token,
                                                       take))
    err = torch.where(have < n, ERR_WAIT_UNDERFLOW, 0).to(torch.int32)
    return replace(state, credits=hd.drain_credits(state.credits, token, n),
                   error=state.error | err)
