"""Admission front-end: the serving tier's entry point with backpressure
(the port of ``repro.serving.frontend``: host Python, line for line).

The engine (single-host or disaggregated) exposes ``submit``/``step``;
what production traffic needs on top is *admission control*: a bounded
job queue, explicit rejection when the queue is full (backpressure the
caller can see, instead of unbounded latency), request status, and a
runner that keeps lanes fed.  That is this module — the Shoal analogue
of a web tier's job queue + worker loop.

Lane accounting flows through the engine's existing
:class:`~repro_torch.actors.events.EventMailbox`: the front-end chains itself
onto the sink, so one batched event delivery per decode step updates
job states and the busy-lane set — no per-token polling of request
objects.

Thread model: ``submit`` and the runner are lock-serialized, so the
front-end can be driven synchronously (``pump`` / ``run_until_idle``,
what the tests and benchmarks do) or by a background runner thread
(``start`` / ``stop``).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque

import numpy as np

from repro_torch.actors.events import SlotEvent
from repro_torch.serving.engine import Request

QUEUED = "queued"
RUNNING = "running"
DONE = "done"
REJECTED = "rejected"
TIMED_OUT = "timed_out"


@dataclasses.dataclass
class Job:
    """One admitted (or rejected) generation request."""

    rid: int
    request: Request
    status: str = QUEUED
    deadline: float | None = None     # absolute time.monotonic() cutoff

    @property
    def tokens(self) -> list[int]:
        return self.request.out


class ServeFrontend:
    """Bounded admission queue over a serving engine.

    Args:
      engine: anything with the ``ServeEngine`` scheduler surface
        (``submit(Request) -> bool``, ``step()``, ``drain()``, ``idle``)
        — the single-host engine or the disaggregated tier.
      max_queue: admission bound.  ``submit`` beyond it returns a
        REJECTED job immediately — the backpressure contract; queued
        depth never exceeds this.
      events: the engine's EventMailbox(es) to chain onto for slot
        accounting; defaults to ``engine.events`` when present.
    """

    def __init__(self, engine, *, max_queue: int = 64, events=None):
        if max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        self.engine = engine
        self.max_queue = int(max_queue)
        self._queue: deque[Job] = deque()
        self.jobs: dict[int, Job] = {}
        self._next_rid = 0
        self._lock = threading.RLock()
        self._runner: threading.Thread | None = None
        self._stop = threading.Event()
        # stats
        self.admitted = 0
        self.rejected = 0
        self.completed = 0
        self.expired = 0
        self.peak_queue_depth = 0
        self.busy_lanes: set[tuple] = set()
        self._chain_events(events)

    # -- event-mailbox integration -------------------------------------------

    def _chain_events(self, events) -> None:
        if events is None:
            mailboxes = []
            if hasattr(self.engine, "events"):
                mailboxes = [(None, self.engine.events)]
            elif hasattr(self.engine, "engines"):
                mailboxes = [(did, eng.events)
                             for did, eng in self.engine.engines.items()]
        else:
            mailboxes = [(None, mb) for mb in events]
        for tag, mb in mailboxes:
            prev = mb.sink
            mb.sink = self._make_sink(tag, prev)

    def _make_sink(self, tag, prev):
        def sink(batch):
            self._on_events(tag, batch)
            if prev is not None:
                prev(batch)
        return sink

    def _on_events(self, tag, batch: list[SlotEvent]) -> None:
        """One batched delivery per engine flush (the mailbox contract):
        acquire/release events drive job state, never per-token polls."""
        with self._lock:
            for e in batch:
                key = (tag, e.lane)
                if e.kind == "acquire":
                    self.busy_lanes.add(key)
                elif e.kind == "release":
                    self.busy_lanes.discard(key)
                    job = self.jobs.get(e.rid)
                    if job is not None and job.status != DONE:
                        job.status = DONE
                        self.completed += 1

    # -- admission -----------------------------------------------------------

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    def submit(self, prompt, max_new: int, *, deadline_s: float | None = None,
               retries: int = 0, backoff_s: float = 0.002) -> Job:
        """Admit a request, or reject it when the queue is full.

        Graceful degradation instead of a hard cliff: ``retries`` > 0
        re-attempts a full-queue admission with exponential backoff
        (``backoff_s`` doubling each attempt, lock released while
        sleeping) before giving up with REJECTED, and ``deadline_s``
        bounds how long the job may sit unfinished — :meth:`pump`
        expires overdue queued jobs to TIMED_OUT rather than serving
        them arbitrarily late.  With the defaults the call never blocks
        and the queue never grows past ``max_queue``."""
        delay = float(backoff_s)
        for attempt in range(int(retries) + 1):
            with self._lock:
                if len(self._queue) < self.max_queue:
                    rid = self._next_rid
                    self._next_rid += 1
                    req = Request(rid=rid,
                                  prompt=np.asarray(prompt, np.int32),
                                  max_new=int(max_new))
                    job = Job(rid=rid, request=req, status=QUEUED,
                              deadline=(None if deadline_s is None
                                        else time.monotonic() + deadline_s))
                    self.jobs[rid] = job
                    self._queue.append(job)
                    self.admitted += 1
                    self.peak_queue_depth = max(self.peak_queue_depth,
                                                len(self._queue))
                    return job
            if attempt < retries:
                time.sleep(delay)     # outside the lock: let pump() drain
                delay *= 2
        with self._lock:
            rid = self._next_rid
            self._next_rid += 1
            req = Request(rid=rid,
                          prompt=np.asarray(prompt, np.int32),
                          max_new=int(max_new))
            job = Job(rid=rid, request=req, status=REJECTED)
            self.jobs[rid] = job
            self.rejected += 1
            return job

    def status(self, rid: int) -> str:
        with self._lock:
            job = self.jobs.get(rid)
            if job is None:
                raise KeyError(f"unknown rid {rid}")
            return job.status

    def result(self, rid: int) -> list[int] | None:
        """Generated tokens once DONE, else None (REJECTED raises)."""
        with self._lock:
            job = self.jobs.get(rid)
            if job is None:
                raise KeyError(f"unknown rid {rid}")
            if job.status == REJECTED:
                raise ValueError(f"rid {rid} was rejected (queue full)")
            if job.status == TIMED_OUT:
                raise ValueError(f"rid {rid} timed out before admission "
                                 "(deadline_s elapsed in the queue)")
            return list(job.tokens) if job.status == DONE else None

    # -- the runner ----------------------------------------------------------

    def pump(self) -> bool:
        """One scheduler turn: expire overdue queued jobs, admit the
        rest onto free lanes, then one decode step.  Returns True if
        any work remains."""
        with self._lock:
            now = time.monotonic()
            while self._queue:
                job = self._queue[0]
                if job.deadline is not None and now > job.deadline:
                    # overdue before it ever ran: shed it rather than
                    # serve a response nobody is waiting for anymore
                    job.status = TIMED_OUT
                    self.expired += 1
                    self._queue.popleft()
                    continue
                if not self.engine.submit(job.request):
                    break   # decode lanes saturated: jobs wait, queue bounded
                job.status = RUNNING
                self._queue.popleft()
            self.engine.step()
            return bool(self._queue) or not self.engine.idle

    def run_until_idle(self) -> None:
        """Synchronous drive to completion (tests / benchmarks)."""
        while self.pump():
            pass
        with self._lock:
            self.engine.drain()

    def start(self, poll_s: float = 0.001) -> None:
        """Background runner thread: pump while work exists, nap when
        idle.  ``stop()`` ends it and drains the engine's mailboxes."""
        if self._runner is not None:
            raise RuntimeError("runner already started")
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                if not self.pump():
                    time.sleep(poll_s)

        self._runner = threading.Thread(target=loop, daemon=True,
                                        name="serve-frontend")
        self._runner.start()

    def stop(self, timeout: float = 30.0) -> None:
        """Stop the runner and drain the engine.  ``join`` returning is
        NOT success — a wedged runner leaves it alive past the timeout,
        and silently continuing would drain the engine under a thread
        still pumping it.  Raises RuntimeError in that case (the runner
        is kept so a later ``stop`` can retry)."""
        if self._runner is None:
            return
        self._stop.set()
        self._runner.join(timeout)
        if self._runner.is_alive():
            raise RuntimeError(
                f"serve-frontend runner failed to stop within {timeout}s "
                "(thread still alive; engine NOT drained)")
        self._runner = None
        with self._lock:
            self.engine.drain()

    def stats(self) -> dict:
        with self._lock:
            return dict(admitted=self.admitted, rejected=self.rejected,
                        completed=self.completed, expired=self.expired,
                        peak_queue_depth=self.peak_queue_depth,
                        queue_depth=len(self._queue),
                        busy_lanes=len(self.busy_lanes))
