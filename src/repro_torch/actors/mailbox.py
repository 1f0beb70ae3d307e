"""Mailboxes: aggregation of tiny AMs into one packet stack.

A :class:`Mailbox` is bound to one ``pattern`` (who talks to whom this
phase) and a fixed per-message word capacity.  ``send`` appends a
message -- a header-field record plus a zero-padded payload row -- into
the pending stack; when the stack reaches the watermark (or ``flush`` is
called at a phase boundary) the whole stack ships as ONE fused ``(K, n,
HDR_WORDS + msg_words)`` exchange and is absorbed by the mixed-class
GAScore ingress (:func:`repro_torch.core.gascore.ingress_stack`): its
Long rows land as one DataMover scatter.  N tiny messages therefore
cost one exchange instead of N.

Reply coalescing: on an acked transport every row in the stack is
marked async except the last, whose ack token is forced to the
*mailbox* token -- so one flush earns exactly ONE credit on
``mailbox.token``, regardless of how many messages it carried or what
per-message tokens/flags they used.  ``wait_replies(token=mb.token,
n=mb.flushes)`` is the phase-boundary fence.

Payloads and header fields: a Python or numpy value is the same on
every kernel and stays on the host until the flush, so a 1024-message
flush copies one stacked array to the device, not 1024 rows.  A tensor
payload is ``(K, w)`` (one row per kernel) or ``(w,)`` (the same row
on every kernel); a tensor field is ``(K,)``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.analysis import trace as _lint
from repro_torch.core import am
from repro_torch.core import gascore as gc
from repro_torch.core import handlers as hd
from repro_torch.core import ops
from repro_torch.core.state import PgasState, ShoalContext, replace

DEFAULT_WATERMARK = 64

# header fields a mailbox records per message (src/dst/seq are uniform
# across the stack and broadcast at flush time)
_ROW_FIELDS = ("type", "nwords", "dst_addr", "handler", "token")


def _is_concrete(x) -> bool:
    return isinstance(x, (int, float, np.integer, np.floating, np.ndarray,
                          list, tuple))


class Mailbox:
    """Per-destination coalescing mailbox over a Shoal context.

    Args:
      ctx: the Shoal context (transport decides acked/async flushes).
      pattern: ``[(src, dst), ...]`` the stack ships along.
      msg_words: payload word capacity per message (rows are zero-padded
        to this width; Short rows carry zeros).
      watermark: pending-message count that triggers an automatic flush
        from inside ``send``; ``flush`` may be called earlier at any
        phase boundary.
      token: credit token the per-flush ack lands on.
      dtype: payload dtype (must be 32-bit to bitcast onto the wire).
      reply_via: optional :class:`ReplyMailbox` to defer even the
        one-per-flush ack into.
    """

    def __init__(self, ctx: ShoalContext, pattern, *, msg_words: int,
                 watermark: int = DEFAULT_WATERMARK, token: int = 0,
                 dtype=torch.float32, reply_via=None):
        if not am.wire_dtype_ok(dtype):
            raise TypeError(
                f"mailbox payload dtype must be 32-bit (wire bitcast), "
                f"got {dtype}")
        if msg_words < 1:
            raise ValueError("msg_words must be >= 1")
        if watermark < 1:
            raise ValueError("watermark must be >= 1")
        self.ctx = ctx
        self.pattern = list(pattern)
        self.msg_words = int(msg_words)
        self.watermark = int(watermark)
        self.token = int(token)
        self.dtype = dtype
        self.reply_via = reply_via
        self._fields: list[dict] = []
        self._payloads: list = []
        # (class, addr, nwords, handler, token) per message, for the lint
        self._lint_rows: list[tuple] = []
        self._tx_words = 0
        self.flushes = 0
        self.msgs_sent = 0

    @property
    def pending(self) -> int:
        return len(self._fields)

    def __len__(self) -> int:
        return len(self._fields)

    # -- enqueue ---------------------------------------------------------------

    def _pad_row(self, payload):
        """Zero-pad one payload to ``msg_words`` lanes: a ``(msg_words,)``
        numpy row for a concrete value, a ``(K, msg_words)`` tensor for
        a tensor."""
        if _is_concrete(payload):
            row = np.asarray(payload, _np_dtype(self.dtype)).reshape(-1)
            size = row.size
        else:
            row = payload.to(device=self.ctx.device, dtype=self.dtype)
            if row.dim() != 2 or row.shape[0] != self.ctx.num_kernels:
                row = row.reshape(1, -1).expand(self.ctx.num_kernels, -1)
            size = row.shape[1]
        if size > self.msg_words:
            raise ValueError(
                f"mailbox message of {size} words exceeds msg_words="
                f"{self.msg_words}; use put_long for big messages")
        if isinstance(row, np.ndarray):
            return np.pad(row, (0, self.msg_words - size)), size
        return torch.nn.functional.pad(row, (0, self.msg_words - size)), size

    def send(self, state: PgasState, payload=None, *, dst_addr=0,
             handler=hd.H_WRITE, msg_class: int = am.LONG, token=None,
             arg=1) -> PgasState:
        """Append one tiny AM to the pending stack.

        Long messages land ``payload`` in the destination segment at
        ``dst_addr`` through ``handler``; Short messages (no payload)
        run ``handler`` on the destination's credit word ``token`` with
        ``arg`` -- the signaling/credit-return class.  Returns ``state``
        unchanged unless the watermark triggers an automatic flush.
        """
        if msg_class == am.SHORT:
            if payload is not None:
                raise ValueError("Short mailbox messages carry no payload")
            row, nwords = np.zeros((self.msg_words,),
                                   _np_dtype(self.dtype)), 0
            dst_addr = arg                       # Short: dst_addr = handler arg
        elif msg_class == am.LONG:
            if payload is None:
                raise ValueError("Long mailbox messages need a payload")
            row, nwords = self._pad_row(payload)
        else:
            raise ValueError(
                "mailboxes aggregate Short and Long AMs; Medium delivery "
                "(payload to kernel) has no coalesced ingress")
        t = am.make_type(msg_class, asynchronous=True,
                         fifo=msg_class == am.LONG)
        row_token = self.token if token is None else token
        self._fields.append(dict(
            type=t, nwords=nwords, dst_addr=dst_addr, handler=handler,
            token=row_token))
        self._lint_rows.append((msg_class, _lint.known_int(dst_addr),
                                nwords, _lint.known_int(handler),
                                _lint.known_int(row_token)))
        self._payloads.append(row)
        self._tx_words += nwords
        self.msgs_sent += 1
        if len(self._fields) >= self.watermark:
            state = self.flush(state)
        return state

    def send_signal(self, state: PgasState, *, handler=hd.H_ADD, arg=1,
                    token=None) -> PgasState:
        """Short-AM convenience: enqueue a signal/credit-return."""
        return self.send(state, None, msg_class=am.SHORT, handler=handler,
                         arg=arg, token=token)

    # -- flush -----------------------------------------------------------------

    def _stack_column(self, name):
        """``(n,)`` (uniform) or ``(K, n)`` int32 column of one field."""
        vals = [f[name] for f in self._fields]
        dev = self.ctx.device
        if all(_is_concrete(v) for v in vals):
            return torch.from_numpy(np.asarray(vals, np.int32)).to(dev)
        K = self.ctx.num_kernels
        return torch.stack([torch.as_tensor(v, dtype=torch.int32,
                                            device=dev).expand(K)
                            for v in vals], dim=1)

    def _stack_payloads(self):
        """``(K, n, msg_words)`` payload rows."""
        K, dev = self.ctx.num_kernels, self.ctx.device
        if all(isinstance(r, np.ndarray) for r in self._payloads):
            rows = torch.from_numpy(np.stack(self._payloads)).to(dev)
            return rows.expand(K, -1, -1)
        return torch.stack([
            torch.from_numpy(r).to(dev).expand(K, -1)
            if isinstance(r, np.ndarray) else r for r in self._payloads],
            dim=1)

    def _additive(self) -> bool | None:
        """:func:`repro_torch.core.gascore.adds_only` of the pending
        stack's Short rows (a tensor handler is not known on the host)."""
        return gc.adds_only(self.ctx.handlers, [
            ops.static_int(f["handler"]) for f in self._fields
            if f["type"] & 7 == am.SHORT])

    def _stack(self):
        """Masked ``(K, n, HDR)`` headers and ``(K, n, msg_words)``
        payloads of the pending stack, the final row acked on an acked
        transport; clears the stack."""
        n = len(self._fields)
        ctx = self.ctx
        cols = {name: self._stack_column(name) for name in _ROW_FIELDS}
        hdrs = am.encode_batch(n, src=ops._col(ctx.my_id()),
                               dst=ops._col(ops._dst_of(ctx, self.pattern)),
                               **cols)
        if ctx.transport.acked:
            # one ack per flush: only the final row requests a reply
            # (clear async BEFORE masking so non-senders stay all-NOP)
            hdrs[:, n - 1, 0] &= ~am.FLAG_ASYNC
        hdrs = ops._mask_nonparticipants(ctx, self.pattern, hdrs)
        pays = self._stack_payloads()
        tx = torch.where(ops._is_sender(ctx, self.pattern), self._tx_words,
                         0).to(torch.int32)
        self._fields.clear()
        self._payloads.clear()
        self._lint_rows.clear()
        self._tx_words = 0
        self.flushes += 1
        return hdrs, pays, tx

    def _emit_flush(self, mailbox_id: int, **kw) -> str | None:
        """Record the pending stack's flush as one comm event: its Long
        rows' write intervals and its Short H_ADD rows' credit grants
        (a Short row's ``dst_addr`` is its handler argument)."""
        w_ivs, grants = [], []
        for cls, addr, nw, h_s, tok in self._lint_rows:
            if cls == am.LONG and nw:
                w_ivs.append(_lint.Interval(addr, nw))
            elif (cls == am.SHORT and h_s == hd.H_ADD
                  and addr is not None and tok is not None):
                grants.append((tok, addr))
        return _lint.emit(
            "mailbox_flush", self.pattern, writes=tuple(w_ivs),
            token=self.token, acked=self.ctx.transport.acked,
            credit_grants=tuple(grants), mailbox_id=mailbox_id,
            segment_words=self.ctx.segment_words, **kw)

    def flush(self, state: PgasState) -> PgasState:
        """Ship the pending stack as one exchange and absorb it.

        No-op when nothing is pending.  On an acked transport the last
        row's async bit is cleared and its ack rides the *mailbox*
        token: exactly one credit per flush, however the stack mixed
        handler classes or per-message flags.
        """
        n = len(self._fields)
        if n == 0:
            return state
        tag = self._emit_flush(
            id(self), deferred_reply=self.reply_via is not None,
            detail={"rows": n}) if _lint.active() else None
        with _lint.scope(tag):
            additive = self._additive()
            hdrs, pays, tx = self._stack()
            state = replace(state, tx_words=state.tx_words + tx)
            hdr_r, pay_r = ops._exchange(self.ctx, self.pattern, hdrs, pays)
            state = gc.ingress_stack(self.ctx, state, hdr_r, pay_r,
                                     self.msg_words, additive=additive)
            if self.ctx.transport.acked:
                # the ack is accounted on the mailbox token, not whatever
                # per-message token the final row happened to carry
                h_last = dataclasses.replace(
                    am.decode(hdr_r[:, n - 1]),
                    token=torch.full((self.ctx.num_kernels,), self.token,
                                     dtype=torch.int32,
                                     device=self.ctx.device))
                state = ops._deliver_reply(self.ctx, state, self.pattern,
                                           h_last, token=self.token,
                                           reply_via=self.reply_via)
        return state


def _np_dtype(dtype: torch.dtype):
    return torch.empty((), dtype=dtype).numpy().dtype


class MultiMailbox:
    """One coalescing mailbox over SEVERAL destination patterns.

    A MultiMailbox keeps one pending sub-stack per pattern and flushes
    them TOGETHER: patterns whose source and destination sets are
    disjoint (:func:`repro_torch.core.ops.group_disjoint_patterns`)
    concatenate their stacks and cross the links as ONE exchange per
    group -- the :func:`repro_torch.core.ops.put_long_multi` wire plan
    applied to the actor layer -- absorbed by the same mixed-class
    ingress.

    Ack accounting on an acked transport: the last row of EACH
    pattern's sub-stack is acked and each group adds ONE counted reply
    exchange returning every pattern's ack on the *mailbox* token -- one
    credit per pattern per flush, one reply exchange per group.
    """

    def __init__(self, ctx: ShoalContext, patterns, *, msg_words: int,
                 watermark: int = DEFAULT_WATERMARK, token: int = 0,
                 dtype=torch.float32):
        self.patterns = [list(p) for p in patterns]
        if not self.patterns:
            raise ValueError("MultiMailbox needs at least one pattern")
        self.ctx = ctx
        self.token = int(token)
        self.msg_words = int(msg_words)
        self.watermark = int(watermark)
        # sub-box watermarks are disabled: the MultiMailbox watermark
        # governs the COMBINED pending count so flushes stay grouped
        self._boxes = [Mailbox(ctx, p, msg_words=msg_words,
                               watermark=1 << 30, token=token, dtype=dtype)
                       for p in self.patterns]
        self.groups = ops.group_disjoint_patterns(self.patterns)
        self.flushes = 0

    @property
    def pending(self) -> int:
        return sum(b.pending for b in self._boxes)

    @property
    def msgs_sent(self) -> int:
        return sum(b.msgs_sent for b in self._boxes)

    def send(self, state: PgasState, pattern_idx: int, payload=None,
             **kw) -> PgasState:
        """Append one tiny AM to pattern ``pattern_idx``'s sub-stack
        (same per-message keywords as :meth:`Mailbox.send`)."""
        state = self._boxes[pattern_idx].send(state, payload, **kw)
        if self.pending >= self.watermark:
            state = self.flush(state)
        return state

    def flush(self, state: PgasState) -> PgasState:
        """Ship every pattern's pending sub-stack, one exchange per
        disjoint-pattern group (plus, if acked, one counted reply per
        group).  No-op when nothing is pending anywhere."""
        if self.pending == 0:
            return state
        for grp in self.groups:
            boxes = [self._boxes[i] for i in grp if self._boxes[i].pending]
            if not boxes:
                continue
            group_tag = None
            hdr_rows, pay_rows, union = [], [], []
            adds = [box._additive() for box in boxes]
            additive = None if None in adds else all(adds)
            for box in boxes:
                tag = box._emit_flush(
                    id(self), detail={"rows": box.pending, "multi": True}
                ) if _lint.active() else None
                group_tag = group_tag or tag
                union.extend((s, d) for s, d in box.pattern)
                with _lint.scope(tag):
                    hdrs, pays, tx = box._stack()
                hdr_rows.append(hdrs)
                pay_rows.append(pays)
                state = replace(state, tx_words=state.tx_words + tx)
            union = sorted(set(union))
            with _lint.scope(group_tag):
                hdr_r, pay_r = ops._exchange(self.ctx, union,
                                             torch.cat(hdr_rows, dim=1),
                                             torch.cat(pay_rows, dim=1))
                state = gc.ingress_stack(self.ctx, state, hdr_r, pay_r,
                                         self.msg_words, additive=additive)
                if self.ctx.transport.acked:
                    # the ack lands on the mailbox token regardless of
                    # per-row tokens; any non-async non-NOP row counts
                    state = ops._counted_group_reply(
                        self.ctx, state, union, hdr_r, token=self.token,
                        classes=None)
        self.flushes += 1
        return state


class ReplyMailbox:
    """Deferred-ack aggregation: the reply side of the actor layer.

    Ops called with ``reply_via=this`` skip their immediate auto-reply
    exchange; instead the mailbox records one owed credit per
    ``(pattern, token)``.  ``flush`` returns all owed credits for each
    key as ONE Short AM with ``H_ADD`` and ``arg=count`` along the
    reversed pattern -- K acked puts to a destination cost one reply
    exchange instead of K.
    """

    def __init__(self, ctx: ShoalContext):
        self.ctx = ctx
        self._owed: dict[tuple, int] = {}

    @property
    def pending(self) -> int:
        return sum(self._owed.values())

    def note(self, pattern, token) -> None:
        """Record one owed credit (called by the op layer).

        ``token`` must be one int for every kernel: the coalesced return
        is a single Short AM whose ``arg`` is the credit *count* per
        ``(pattern, token)`` key, so a per-kernel token tensor has no
        key to accumulate under.
        """
        tok = ops.static_int(token)
        if tok is None:
            raise ValueError(
                "ReplyMailbox.note: reply_via coalescing needs one int "
                "token for all kernels -- owed credits are counted per "
                f"(pattern, token), and this token is a "
                f"{type(token).__name__} of per-kernel values. Pass an int "
                "token to the put op, or flush this reply mailbox first "
                "(state = reply_mailbox.flush(state)) and issue the op "
                "with reply_via=None so its ack ships immediately.")
        key = (tuple(tuple(int(x) for x in p) for p in pattern), tok)
        self._owed[key] = self._owed.get(key, 0) + 1

    def flush(self, state: PgasState) -> PgasState:
        """Return every owed credit, one coalesced Short AM per
        (pattern, token): H_ADD with the count as the argument."""
        owed, self._owed = self._owed, {}
        for (pattern, token), count in owed.items():
            state = ops.put_short(
                self.ctx, state, ops._reverse(list(pattern)),
                handler=hd.H_ADD, arg=count, token=token, asynchronous=True)
        return state
