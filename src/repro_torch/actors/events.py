"""Host-side event mailbox (control-plane analogue of the device mailbox),
as in the JAX package's ``repro.actors.events`` (pure Python, copied).

The serve engine emits a slot event per lane transition (acquire on
submit, release on completion).  Delivering each to a scheduler /
metrics sink one at a time is the same tiny-message anti-pattern the
device mailbox exists for, so :class:`EventMailbox` applies the same
contract host-side: events accumulate per mailbox and are delivered to
the sink in ONE batch per watermark hit or explicit phase-boundary
flush (the engine flushes once per decode step).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

DEFAULT_WATERMARK = 64


@dataclasses.dataclass(frozen=True)
class SlotEvent:
    """One serve-engine lane transition."""

    kind: str      # "acquire" | "release"
    lane: int
    rid: int       # request ID occupying / leaving the lane


class EventMailbox:
    """Watermark-buffered event delivery.

    ``send`` appends; the batch goes to ``sink`` (one call, whole list)
    when ``watermark`` events are pending or on ``flush``.  With no sink
    the flushed batch is simply returned — callers can poll.  Counters
    mirror the device mailbox: ``sent`` events in, ``flushes`` batches
    out.
    """

    def __init__(self, watermark: int = DEFAULT_WATERMARK,
                 sink: Callable[[Sequence[SlotEvent]], None] | None = None):
        if watermark < 1:
            raise ValueError("watermark must be >= 1")
        self.watermark = int(watermark)
        self.sink = sink
        self._pending: list[SlotEvent] = []
        self.sent = 0
        self.flushes = 0

    @property
    def pending(self) -> int:
        return len(self._pending)

    def send(self, event: SlotEvent) -> None:
        self._pending.append(event)
        self.sent += 1
        if len(self._pending) >= self.watermark:
            self.flush()

    def flush(self) -> list[SlotEvent]:
        """Deliver the pending batch (no-op when empty)."""
        if not self._pending:
            return []
        batch, self._pending = self._pending, []
        self.flushes += 1
        if self.sink is not None:
            self.sink(batch)
        return batch
