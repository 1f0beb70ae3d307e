"""Spans and counters of the port's layers, recorded on demand.

    from repro_torch.runtime import spans

    with spans.recording() as rec:
        state, _ = trainer.step(state, batch)
    rec.spans        # [Span], in the order they opened
    rec.counters     # {name: int}

A span marks a layer's work on the host: ``with spans.span("model.ffn",
layer=3):``.  Off is the default, and off costs nothing: with no
recording active :func:`span` returns one shared null context (it reads
no clock, opens no ``record_function``, allocates nothing and runs no
tensor operation), as :func:`repro_torch.analysis.trace.scope` does.

While a recording is active each span is two things at once: a
``torch.profiler.record_function`` range, so it lands in any active
profiler's trace over the device's kernels, and a :class:`Span` in the
recording (name, id, parent id, thread, step, start, end, attrs).  Its
start is read just before the range opens and its end just after it
closes, on the profiler's own clock (Unix time in nanoseconds,
``time.time_ns``: what the profiler's events carry), so a trace's
launches and gaps can be laid under the recorded spans.  The range
opens and closes past any Python dispatch mode (the ``dots`` policy's
selective checkpointing never sees it).

Parents are kept per thread.  Autograd runs a CUDA backward pass on a
thread of its own, so a span opened on a thread with no span open takes
as its parent the innermost open ``model.backward`` span, the call of
``torch.autograd.grad``.  Under ``model.backward`` run the activation
checkpointing's recomputation of a block's forward and the backward of
the island's collectives; the model's block spans (:data:`BLOCKS`)
opened there carry ``recompute=True``.  ``train.step`` spans number the
steps: every span carries the index of the ``train.step`` it opened in
(-1 before the first).

Counters sit beside the spans (:func:`add`).  They count forward work:
an add under ``model.backward`` is not counted, so a recomputed block
counts once.  A count held in a tensor is summed on its device and read
once, when the recording ends; nothing in a step syncs for it.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Iterator

import torch

BACKWARD = "model.backward"
STEP = "train.step"
# the model's per-block spans: recomputed when opened under BACKWARD
BLOCKS = frozenset({"model.embed", "model.attention", "model.ffn",
                    "model.head", "model.rglru", "model.xlstm"})

_NULL = contextlib.nullcontext()
_ACTIVE: "Recording | None" = None


class Span:
    """One recorded span; ``end`` is None while it is open."""

    __slots__ = ("name", "id", "parent", "thread", "step", "start", "end",
                 "attrs", "backward")

    def __init__(self, name: str, id: int, parent: "Span | None",
                 thread: int, step: int, attrs: dict):
        self.name, self.id, self.thread, self.step = name, id, thread, step
        self.parent = None if parent is None else parent.id
        # opened under model.backward (recomputation, island backward)
        self.backward = parent is not None and (parent.backward
                                                or parent.name == BACKWARD)
        self.attrs = attrs
        self.start = self.end = None

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"step={self.step}, attrs={self.attrs})")


class Recording:
    """The spans and counters of one :func:`recording` block."""

    def __init__(self) -> None:
        self.spans: list[Span] = []
        self.counters: dict[str, int] = {}
        self.step = -1
        self._tensors: dict[str, torch.Tensor] = {}
        self._local = threading.local()
        self._backward: list[Span] = []      # open model.backward spans

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _innermost(self) -> "Span | None":
        stack = self._stack()
        if stack:
            return stack[-1]
        return self._backward[-1] if self._backward else None

    def _close(self) -> None:
        for name, total in self._tensors.items():
            self.counters[name] = self.counters.get(name, 0) + int(total)
        self._tensors.clear()

    def by_id(self) -> dict[int, Span]:
        return {s.id: s for s in self.spans}

    def path(self, span: Span, ids: dict | None = None) -> str:
        """``outer/.../span`` by name, a recomputed span as
        ``name[recompute]``."""
        ids = self.by_id() if ids is None else ids
        parts = []
        while span is not None:
            parts.append(f"{span.name}[recompute]"
                         if span.attrs.get("recompute") else span.name)
            span = ids.get(span.parent)
        return "/".join(reversed(parts))


class _Span:
    __slots__ = ("rec", "name", "attrs", "rf", "span")

    def __init__(self, rec: Recording, name: str, attrs: dict):
        self.rec, self.name, self.attrs = rec, name, attrs

    def __enter__(self) -> Span:
        rec = self.rec
        parent = rec._innermost()
        if self.name == STEP:
            rec.step += 1
        span = Span(self.name, len(rec.spans), parent, threading.get_ident(),
                    rec.step, self.attrs)
        if span.backward and self.name in BLOCKS:
            span.attrs["recompute"] = True
        self.rf = torch.profiler.record_function(self.name)
        span.start = time.time_ns()
        with torch._C._DisableTorchDispatch():
            self.rf.__enter__()
        rec.spans.append(span)
        rec._stack().append(span)
        if self.name == BACKWARD:
            rec._backward.append(span)
        self.span = span
        return span

    def __exit__(self, *exc) -> bool:
        span, rec = self.span, self.rec
        with torch._C._DisableTorchDispatch():
            self.rf.__exit__(*exc)
        span.end = time.time_ns()
        rec._stack().pop()
        if self.name == BACKWARD:
            rec._backward.remove(span)
        return False


def span(name: str, **attrs):
    """A span of the layer ``name`` with ``attrs``; the :class:`Span` is
    what ``with ... as s`` binds (None when off), so a call site can add
    attrs it learns inside."""
    rec = _ACTIVE
    if rec is None:
        return _NULL
    return _Span(rec, name, attrs)


def counting() -> bool:
    """Whether :func:`add` counts here: a recording is active and this is
    not the backward pass (call sites build a count only then)."""
    rec = _ACTIVE
    if rec is None:
        return False
    inner = rec._innermost()
    return inner is None or not (inner.backward or inner.name == BACKWARD)


def add(name: str, value) -> None:
    """Add ``value`` (an int, or a one-element tensor summed on its
    device) to the counter ``name``, when :func:`counting`."""
    if not counting():
        return
    rec = _ACTIVE
    if torch.is_tensor(value):
        prev = rec._tensors.get(name)
        rec._tensors[name] = value if prev is None else prev + value
    else:
        rec.counters[name] = rec.counters.get(name, 0) + int(value)


@contextlib.contextmanager
def recording() -> Iterator[Recording]:
    """Record spans and counters for the block; the device counters are
    read when it ends."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("spans.recording(): a recording is already "
                           "active")
    rec = Recording()
    _ACTIVE = rec
    try:
        yield rec
    finally:
        _ACTIVE = None
        rec._close()
