"""Comm-safety rules R1-R5 over a recorded event schedule.

The analyzer input is the ordered list of :class:`~repro_torch.analysis.
trace.CommEvent`s one recorded run of the program produced (the port
runs eagerly: the run IS the schedule, every loop iteration included).
The rules model the *paper's* asynchronous PGAS semantics — an AM is
in flight from issue until an ordering point covers it — not the
lockstep emulation, so hazards that today's lockstep exchanges happen
to serialize are still reported: they become real the moment the
transport is an actual NIC.

Ordering model (happens-before at the destination):

* ``barrier`` orders every earlier event before every later one;
* ``wait_replies(token=t)`` orders every earlier *acked* event on
  ``t`` before every later event (for acks deferred through a
  ReplyMailbox, only once a credit-grant for ``t`` has also been
  issued);
* asynchronous events are only ever ordered by a barrier.

Per-kernel (tensor) operands degrade conservatively: an unknown
interval may alias anything, an unknown token makes every token's
balance unknown.
"""

from __future__ import annotations

from repro_torch.analysis.report import ERROR, WARNING, Finding
from repro_torch.analysis.trace import (CommEvent, Interval, READ_OPS,
                                        WRITE_OPS)


def _waiver_of(*events: CommEvent) -> str | None:
    for ev in events:
        if ev.waiver:
            return ev.waiver
    return None


def _common_dsts(a: CommEvent, b: CommEvent) -> tuple[int, ...]:
    return tuple(sorted(set(a.dsts) & set(b.dsts)))


def _grant_indices(events, token: int | None):
    """Indices of events that grant credits on ``token``: explicit
    Short-AM grants, a packet whose piggyback lane carries that token's
    deferred acks home, or a ledger drain."""
    out = []
    for k, ev in enumerate(events):
        if any(t == token for t, _ in ev.credit_grants) \
                or (token is not None and ev.piggyback_token == token) \
                or (ev.drains_deferred and ev.token == token):
            out.append(k)
    return out


def _ordered_before(events, i: int, j: int) -> bool:
    """True when an ordering point between events i and j covers event i."""
    ei = events[i]
    for k in range(i + 1, j):
        ev = events[k]
        if ev.op == "barrier":
            return True
        if ev.op == "wait_replies" and ei.acked and ei.token is not None \
                and ev.token == ei.token:
            # acks deferred through a ReplyMailbox or a receiver-side
            # piggyback ledger only order once a grant event (flush,
            # piggyback lane, or drain) sits between the op and the wait
            if not (ei.deferred_reply or ei.defer_ack):
                return True
            if any(i < g < k for g in _grant_indices(events, ei.token)):
                return True
    return False


def _overlapping(a: CommEvent, b: CommEvent):
    """First overlapping (interval, interval) pair, or None."""
    for wa in a.writes:
        for wb in b.writes:
            if wa.overlaps(wb):
                return wa, wb
    return None


# --------------------------------------------------------------------------
# R1: write-write overlap without ordering
# --------------------------------------------------------------------------

def check_r1(events) -> list[Finding]:
    out: list[Finding] = []
    writes = [(i, ev) for i, ev in enumerate(events) if ev.op in WRITE_OPS]
    for a in range(len(writes)):
        i, ei = writes[a]
        # intra-op hazard: the strided aliasing class (vectorized ingress
        # over aliasing blocks scatters in undefined lane order)
        if ei.self_overlap and ei.op == "put_long_strided":
            out.append(Finding(
                rule="R1", severity=ERROR, events=(ei.seq,),
                sites=(ei.site(),), waived=ei.waiver,
                message=(f"strided put {ei.site()} has aliasing blocks "
                         f"(stride {ei.detail.get('stride')} < blk_words "
                         f"{ei.detail.get('blk_words')}) on the unordered "
                         "vectorized ingress: scatter lane order is "
                         "undefined, so last-writer-wins and accumulate "
                         "handlers are both wrong (pass overlap=True or "
                         "drop the override)")))
        for b in range(a + 1, len(writes)):
            j, ej = writes[b]
            common = _common_dsts(ei, ej)
            if not common:
                continue
            pair = _overlapping(ei, ej)
            if pair is None:
                continue
            if _ordered_before(events, i, j):
                continue
            wa, wb = pair
            out.append(Finding(
                rule="R1", severity=ERROR, events=(ei.seq, ej.seq),
                sites=(ei.site(), ej.site()), waived=_waiver_of(ei, ej),
                message=(f"{ei.site()} writes {wa} and {ej.site()} writes "
                         f"{wb} at kernel(s) {list(common)} with no "
                         "ordering (wait_replies on the first op's token, "
                         "or a barrier) between them — destination value "
                         "depends on arrival order")))
    return out


# --------------------------------------------------------------------------
# R2: read overlapping an in-flight write
# --------------------------------------------------------------------------

def check_r2(events) -> list[Finding]:
    out: list[Finding] = []
    for j, ej in enumerate(events):
        if ej.op not in READ_OPS or not ej.reads:
            continue
        for i in range(j):
            ei = events[i]
            if ei.op not in WRITE_OPS or not ei.writes:
                continue
            common = _common_dsts(ei, ej)
            if not common:
                continue
            hit = None
            for r in ej.reads:
                for w in ei.writes:
                    if r.overlaps(w):
                        hit = (w, r)
                        break
                if hit:
                    break
            if hit is None or _ordered_before(events, i, j):
                continue
            w, r = hit
            out.append(Finding(
                rule="R2", severity=ERROR, events=(ei.seq, ej.seq),
                sites=(ei.site(), ej.site()), waived=_waiver_of(ei, ej),
                message=(f"{ej.site()} reads {r} at kernel(s) "
                         f"{list(common)} while {ei.site()}'s write to {w} "
                         "is still in flight (no wait_replies on token "
                         f"{ei.token!r}, no barrier): the get may return "
                         "pre- or post-write data")))
    return out


# --------------------------------------------------------------------------
# R3: credit flow (underflow / leak / double-spend)
# --------------------------------------------------------------------------

def check_r3(events) -> list[Finding]:
    out: list[Finding] = []
    balance: dict[int, int] = {}
    known: dict[int, bool] = {}
    contributors: dict[int, list[CommEvent]] = {}
    mailboxes: dict[int, set[int]] = {}
    # receiver-side piggyback ledger: acks a defer_ack put owes, pending
    # a reverse-link packet (piggyback_token) or an explicit drain
    deferred: dict[int, int] = {}
    deferred_evs: dict[int, list[CommEvent]] = {}
    all_unknown = False

    def bump(token, n, ev):
        if token is None:
            return
        balance[token] = balance.get(token, 0) + n
        contributors.setdefault(token, []).append(ev)

    for ev in events:
        if ev.op == "wait_replies":
            if ev.token is None:
                all_unknown = True      # per-kernel token: drains *some*
                continue
            t = ev.token
            if ev.wait_n is None:
                known[t] = False
                contributors.pop(t, None)
                mailboxes.pop(t, None)
                continue
            if ev.timeout:
                # timeout wait: drains min(have, n) and latches nothing —
                # a shortfall is the *expected* outcome under loss, so no
                # underflow finding; the balance cannot go negative
                balance[t] = max(balance.get(t, 0) - ev.wait_n, 0)
                contributors.pop(t, None)
                mailboxes.pop(t, None)
                continue
            if not all_unknown and known.get(t, True) \
                    and ev.wait_n > balance.get(t, 0):
                issued = balance.get(t, 0)
                out.append(Finding(
                    rule="R3", severity=ERROR, events=(ev.seq,),
                    sites=(ev.site(),), waived=ev.waiver,
                    message=(f"{ev.site()} waits for {ev.wait_n} replies "
                             f"on token {t} but the schedule issues only "
                             f"{issued} acked credit(s) — this is the "
                             "trace-time form of ERR_WAIT_UNDERFLOW (a "
                             "hang in the threaded original)")))
            balance[t] = balance.get(t, 0) - ev.wait_n
            contributors.pop(t, None)
            mailboxes.pop(t, None)
            continue
        if ev.token is None and (ev.acked or ev.credit_grants
                                 or ev.drains_deferred):
            all_unknown = True
            continue
        # the piggyback lane is loaded from the ledger as of SEND time,
        # so it moves acks pooled by *earlier* events (including this
        # call's own defer, which lands at the receiver only afterwards)
        if ev.piggyback_token is not None:
            moved = deferred.pop(ev.piggyback_token, 0)
            if moved:
                bump(ev.piggyback_token, moved, ev)
            deferred_evs.pop(ev.piggyback_token, None)
        if ev.drains_deferred:
            moved = deferred.pop(ev.token, 0)
            if moved:
                bump(ev.token, moved, ev)
            deferred_evs.pop(ev.token, None)
            continue
        if ev.acked and not ev.deferred_reply:
            if ev.defer_ack:
                deferred[ev.token] = deferred.get(ev.token, 0) + 1
                deferred_evs.setdefault(ev.token, []).append(ev)
            else:
                bump(ev.token, 1, ev)
        for t, n in ev.credit_grants:
            bump(t, n, ev)
            contributors.setdefault(t, [])
        if ev.mailbox_id is not None and ev.acked and ev.token is not None:
            seen = mailboxes.setdefault(ev.token, set())
            seen.add(ev.mailbox_id)
            if len(seen) > 1:
                out.append(Finding(
                    rule="R3", severity=WARNING, events=(ev.seq,),
                    sites=(ev.site(),), waived=ev.waiver,
                    message=(f"token {ev.token} collects flush acks from "
                             f"{len(seen)} distinct mailboxes with no "
                             "wait_replies between flushes — a "
                             "double-spend hazard: wait counts can no "
                             "longer be attributed per mailbox")))
    if not all_unknown:
        for t, bal in sorted(balance.items()):
            if bal > 0 and known.get(t, True):
                evs = contributors.get(t, [])
                out.append(Finding(
                    rule="R3", severity=WARNING,
                    events=tuple(e.seq for e in evs),
                    sites=tuple(e.site() for e in evs),
                    waived=_waiver_of(*evs) if evs else None,
                    message=(f"{bal} credit(s) on token {t} are never "
                             "consumed by a wait_replies — leaked acks "
                             "(flush/put without credit consumption) "
                             "accumulate across phases and corrupt later "
                             "wait counts")))
        for t, cnt in sorted(deferred.items()):
            if cnt > 0 and known.get(t, True):
                evs = deferred_evs.get(t, [])
                out.append(Finding(
                    rule="R3", severity=WARNING,
                    events=tuple(e.seq for e in evs),
                    sites=tuple(e.site() for e in evs),
                    waived=_waiver_of(*evs) if evs else None,
                    message=(f"{cnt} deferred ack(s) on token {t} are "
                             "stranded in the receiver ledger: no later "
                             "reverse-link packet piggybacks them "
                             "(piggyback_token) and no drain_deferred_acks "
                             "ships them, so the sender's wait_replies on "
                             f"token {t} can never be satisfied")))
    return out


# --------------------------------------------------------------------------
# R4: out-of-bounds and vectored aliasing
# --------------------------------------------------------------------------

def _oob(iv: Interval, segment_words: int) -> bool:
    return iv.known and (iv.start < 0 or iv.start + iv.words > segment_words)


def check_r4(events) -> list[Finding]:
    out: list[Finding] = []
    for ev in events:
        if not ev.segment_words:
            continue
        for kind, ivs in (("write", ev.writes), ("read", ev.reads)):
            for iv in ivs:
                if _oob(iv, ev.segment_words):
                    out.append(Finding(
                        rule="R4", severity=ERROR, events=(ev.seq,),
                        sites=(ev.site(),), waived=ev.waiver,
                        message=(f"{ev.site()} {kind}s {iv} outside the "
                                 f"{ev.segment_words}-word segment: the "
                                 "GAScore clips out-of-range addresses "
                                 "silently, so part of the message is "
                                 "dropped (or lands at the clip boundary)")))
        if ev.op == "put_long_vectored" and ev.self_overlap:
            alias = ev.detail.get("alias", "duplicate/overlapping addresses")
            out.append(Finding(
                rule="R4", severity=ERROR, events=(ev.seq,),
                sites=(ev.site(),), waived=ev.waiver,
                message=(f"vectored put {ev.site()} has aliasing "
                         f"destination blocks in one packet ({alias}): "
                         "the receiver's scatter makes the result depend "
                         "on block order")))
    return out


# --------------------------------------------------------------------------
# R5: loss-resilience protocol hygiene on lossy transports
# --------------------------------------------------------------------------

def check_r5(events) -> list[Finding]:
    """Lossy-link delivery semantics.

    A retransmitting put whose receiver does not dedup redelivery is an
    ERROR: a duplicated or re-sent segment is applied twice, which
    corrupts accumulate handlers (H_ADD) and re-runs any non-idempotent
    handler.  An acked put with no retry budget, or a fire-and-forget
    put, on a lossy link is a WARNING — losses surface as
    ERR_RETRY_EXHAUSTED / silent data loss respectively, which may be a
    deliberate degradation policy but deserves a waiver saying so.
    """
    out: list[Finding] = []
    for ev in events:
        if not ev.lossy or ev.op not in WRITE_OPS:
            continue
        if ev.retries > 0 and not ev.dedup:
            out.append(Finding(
                rule="R5", severity=ERROR, events=(ev.seq,),
                sites=(ev.site(),), waived=ev.waiver,
                message=(f"{ev.site()} retransmits (up to {ev.retries}x) "
                         "over a lossy link with dedup=False: a lost ack "
                         "re-delivers segments the receiver already "
                         "applied, so handlers run twice (double-applied "
                         "H_ADD, re-run side effects) — enable the dedup "
                         "ledger or drop the retry budget")))
        elif ev.acked and ev.retries == 0:
            out.append(Finding(
                rule="R5", severity=WARNING, events=(ev.seq,),
                sites=(ev.site(),), waived=ev.waiver,
                message=(f"{ev.site()} is acked over a lossy link with no "
                         "retransmit budget (max_retries=0): any single "
                         "drop latches ERR_RETRY_EXHAUSTED immediately")))
        elif not ev.acked:
            out.append(Finding(
                rule="R5", severity=WARNING, events=(ev.seq,),
                sites=(ev.site(),), waived=ev.waiver,
                message=(f"{ev.site()} is fire-and-forget over a lossy "
                         "link: drops and corruptions are silent data "
                         "loss (no ack, no retransmit) — acceptable only "
                         "if the application tolerates holes")))
    return out


def analyze(events) -> list[Finding]:
    """Run all pass-1 rules over a recorded schedule."""
    findings: list[Finding] = []
    findings.extend(check_r1(events))
    findings.extend(check_r2(events))
    findings.extend(check_r3(events))
    findings.extend(check_r4(events))
    findings.extend(check_r5(events))
    return findings
