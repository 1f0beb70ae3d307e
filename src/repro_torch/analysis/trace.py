"""Comm-event recording of the port's shoal-lint.

Every Shoal op call site (:mod:`repro_torch.core.ops`, the actor
mailboxes in :mod:`repro_torch.actors`) reports one :class:`CommEvent`
here while a recorder is active, carrying the host-known operands the
analyzer needs: per-destination address intervals, tokens, ack
semantics, segmentation.

The port runs eagerly, so its program *is* its execution: a recorder
installed around one run (:func:`record`) sees every op that run
issues, in issue order.  A Python loop contributes every iteration (the
JAX package traces a ``lax.scan`` body once and records one instance).

:func:`scope` takes the place of ``jax.named_scope``: it pushes an
event's ``shoal.<op>#e<seq>`` tag onto a stack, and while a recorder is
active every exchange the op layer makes (``ops._permute``) is counted
against the innermost tag -- the port's :func:`recover_tags`.

Recording costs nothing when no recorder is active: call sites test
:func:`active` before they build an event, and :func:`scope` then
returns one shared null context, so no event, interval or tag is built
and no tensor operation runs.

Tensor operands (per-kernel ``(K,)`` addresses, tokens, wait counts)
are recorded as unknown (``None``) without being read
(:func:`known_int`): reading one would be a host sync.  An unknown
interval is treated by the rules as possibly overlapping everything in
its segment.

Deliberate hazards are annotated inline with :func:`waiver`::

    with analysis.waiver("double-write is idempotent here"):
        state = ops.put_long(ctx, state, pay, pattern, dst_addr=0)

Events emitted under a waiver still produce findings, but the findings
are marked waived and do not fail ``lint_clean`` / the CLI.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator

import torch

# ops that write destination segment memory
WRITE_OPS = ("put_long", "put_long_strided", "put_long_vectored",
             "put_long_multi", "mailbox_flush")
# ops that read remote segment memory
READ_OPS = ("get_medium", "get_long")
# ordering / bookkeeping ops
SYNC_OPS = ("wait_replies", "barrier")


@dataclasses.dataclass(frozen=True)
class Interval:
    """A destination-segment word range ``[start, start + words)``.

    ``start=None`` is an address not known on the host (a per-kernel
    tensor): the analyzer must assume the interval may alias anything in
    the segment.
    """

    start: int | None
    words: int

    @property
    def known(self) -> bool:
        return self.start is not None

    def overlaps(self, other: "Interval") -> bool:
        if not (self.known and other.known):
            return True          # conservatively aliasing
        return (self.start < other.start + other.words
                and other.start < self.start + self.words)

    def __str__(self) -> str:
        if not self.known:
            return f"[?, ?+{self.words})"
        return f"[{self.start}, {self.start + self.words})"


@dataclasses.dataclass
class CommEvent:
    """One comm-op call, as recorded while the program ran."""

    seq: int                            # event index in issue order
    op: str                             # op name ("put_long", ...)
    pattern: tuple[tuple[int, int], ...]
    writes: tuple[Interval, ...] = ()   # intervals written at each dst
    reads: tuple[Interval, ...] = ()    # intervals read at each remote src
    token: int | None = None            # None = per-kernel token
    acked: bool = False                 # earns one credit on `token`
    asynchronous: bool = False
    deferred_reply: bool = False        # ack routed through a ReplyMailbox
    defer_ack: bool = False             # ack ledgered at the receiver
    piggyback_token: int | None = None  # this packet carries that token's
                                        # deferred acks home (grants them)
    drains_deferred: bool = False       # drain_deferred_acks: ships the
                                        # residual ledger for `token`
    wait_n: int | None = None           # wait_replies count (None = per
                                        # kernel)
    timeout: bool = False               # wait_replies: partial-drain path
    lossy: bool = False                 # traverses a fault-injecting link
    retries: int = 0                    # retransmit bound (0 = no retry)
    dedup: bool = True                  # receiver dedups redelivery (R5)
    credit_grants: tuple[tuple[int, int], ...] = ()  # (token, count) grants
    handler: int | None = None
    segment_words: int = 0
    mailbox_id: int | None = None       # id() of the flushing Mailbox
    ordered_ingress: bool = True        # strided: sequential ingress?
    self_overlap: bool = False          # intra-op aliasing possible
    waiver: str | None = None
    tag: str = ""                       # "shoal.<op>#e<seq>" scope tag
    detail: dict = dataclasses.field(default_factory=dict)

    @property
    def dsts(self) -> tuple[int, ...]:
        return tuple(sorted({d for _, d in self.pattern}))

    @property
    def srcs(self) -> tuple[int, ...]:
        return tuple(sorted({s for s, _ in self.pattern}))

    def site(self) -> str:
        return f"{self.op}#e{self.seq}"


class Recorder:
    """Collects :class:`CommEvent`s while installed (see :func:`record`),
    and the exchanges made under each event's scope tag."""

    def __init__(self) -> None:
        self.events: list[CommEvent] = []
        self.tags: dict[str, int] = {}  # tag -> exchanges under its scope
        self.unattributed = 0           # exchanges outside every scope

    def next_seq(self) -> int:
        return len(self.events)

    @property
    def exchanges(self) -> int:
        """Every exchange of the op layer made while recording."""
        return sum(self.tags.values()) + self.unattributed


_RECORDERS: list[Recorder] = []
_WAIVERS: list[str] = []
_SCOPES: list[str] = []
_OFF = contextlib.nullcontext()


def active() -> bool:
    return bool(_RECORDERS)


def current_waiver() -> str | None:
    return _WAIVERS[-1] if _WAIVERS else None


@contextlib.contextmanager
def record() -> Iterator[Recorder]:
    """Install a fresh recorder for the duration of a run."""
    rec = Recorder()
    _RECORDERS.append(rec)
    try:
        yield rec
    finally:
        _RECORDERS.remove(rec)


@contextlib.contextmanager
def waiver(reason: str) -> Iterator[None]:
    """Mark comm ops in this block as deliberate (inline waiver).

    Findings whose every involved event carries a waiver are reported
    as waived and do not fail the lint.  The waiver also downgrades the
    op layer's aliasing rejections (overlapping vectored or batched
    destination intervals) to analyzer findings, so a deliberately
    order-dependent packet can be expressed at all.
    """
    if not reason or not str(reason).strip():
        raise ValueError("waiver() needs a non-empty reason string")
    _WAIVERS.append(str(reason))
    try:
        yield
    finally:
        _WAIVERS.pop()


def static_int(x) -> int | None:
    """``int(x)`` for a Python or one-element value, else ``None`` (the
    op layer's check that an argument is one int for all kernels; a
    one-element device tensor is read, which syncs the host)."""
    if torch.is_tensor(x) and x.numel() != 1:
        return None
    try:
        return int(x)
    except (TypeError, ValueError):
        return None


def known_int(x) -> int | None:
    """``int(x)`` for a host value, ``None`` for any tensor, which is
    never read: the recording path makes no host sync."""
    if torch.is_tensor(x):
        return None
    try:
        return int(x)
    except (TypeError, ValueError):
        return None


def emit(op: str, pattern, **kw) -> str | None:
    """Record one comm event in the active recorder and return its
    ``shoal.<op>#e<seq>`` tag for :func:`scope`; ``None`` when no
    recorder is active (call sites test :func:`active` first, so the
    event's operands are built only while recording)."""
    if not _RECORDERS:
        return None
    rec = _RECORDERS[-1]
    seq = rec.next_seq()
    tag = f"shoal.{op}#e{seq}"
    rec.events.append(CommEvent(
        seq=seq, op=op, pattern=tuple((int(s), int(d)) for s, d in pattern),
        tag=tag, waiver=current_waiver(), **kw))
    return tag


class _Scope:
    __slots__ = ("tag",)

    def __init__(self, tag: str) -> None:
        self.tag = tag

    def __enter__(self) -> None:
        _SCOPES.append(self.tag)

    def __exit__(self, *exc) -> None:
        _SCOPES.pop()


def scope(tag: str | None):
    """The op's scope: exchanges made inside it count against ``tag``
    while a recorder is active; a shared null context otherwise."""
    if tag is None or not _RECORDERS:
        return _OFF
    return _Scope(tag)


def note_exchange() -> None:
    """Count one exchange of the op layer against the innermost scope
    tag of the active recorder (no-op when none is active)."""
    if _RECORDERS:
        rec = _RECORDERS[-1]
        if _SCOPES:
            rec.tags[_SCOPES[-1]] = rec.tags.get(_SCOPES[-1], 0) + 1
        else:
            rec.unattributed += 1


def recover_tags(rec: Recorder) -> dict[str, int]:
    """``{tag: exchanges}`` of one recorded run: which comm call sites
    made link traversals, and how many (the port's counterpart of the
    JAX package's walk over a jaxpr's ``shoal.*`` name stacks)."""
    return dict(rec.tags)


def intervals_for_blocks(addrs, sizes) -> tuple[Interval, ...]:
    """Per-block :class:`Interval`s for a vectored address list; tensor
    addresses become unknown intervals."""
    return tuple(Interval(known_int(a), int(w)) for a, w in zip(addrs, sizes))
