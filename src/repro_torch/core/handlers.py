"""Handler functions and reply/credit counters (paper Secs. II-C1, III-A).

GASNet-style AMs carry a handler ID; the receiver runs the handler on
arrival.  Handlers are pure functions ``(region, payload) -> region``
over the destination-segment slice the payload lands on, so the
built-ins express the classic one-sided verbs: overwrite (plain put),
accumulate (put-with-reduce), min/max.

On the device the GAScore's DataMover write kernel
(:mod:`repro_torch.kernels.am_pack`) takes the built-in IDs 0-4 as an op
code.  A table with custom entries lands block by block there: the
DataMover gather reads each block's region, :meth:`HandlerTable.dispatch`
computes the new one on the device, and the scatter writes it
(``kernels.am_pack.ops.scatter_through_handlers``).

Every array here carries the leading kernel axis ``K``: ``credits`` is
``(K, NUM_TOKENS)`` and per-kernel tokens/counts are ints or ``(K,)``
tensors.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

# Built-in handler IDs (stable ABI; configs and tests use these).
H_NOP = 0
H_WRITE = 1
H_ADD = 2
H_MAX = 3
H_MIN = 4
NUM_BUILTIN = 5

# Credit-counter file size per kernel: tokens index into this.
NUM_TOKENS = 16

HandlerFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

_BUILTINS: tuple[tuple[str, HandlerFn], ...] = (
    ("nop", lambda region, payload: region),
    ("write", lambda region, payload: payload.to(region.dtype)),
    ("add", lambda region, payload: region + payload.to(region.dtype)),
    ("max", lambda region, payload: torch.maximum(region,
                                                  payload.to(region.dtype))),
    ("min", lambda region, payload: torch.minimum(region,
                                                  payload.to(region.dtype))),
)


class HandlerTable:
    """Handler registry, frozen once programs start calling it.

    Users may register additional pure handlers (the software-kernel
    freedom the paper preserves): pure tensor functions, run on the
    segment's device.
    """

    def __init__(self):
        self._entries: list[tuple[str, HandlerFn]] = list(_BUILTINS)

    def register(self, name: str, fn: HandlerFn) -> int:
        """Register a custom handler; returns its handler ID."""
        self._entries.append((name, fn))
        return len(self._entries) - 1

    def __len__(self) -> int:
        return len(self._entries)

    def names(self) -> Sequence[str]:
        return [n for n, _ in self._entries]

    @property
    def builtin_only(self) -> bool:
        """True when the table holds exactly the built-in entries."""
        return len(self._entries) == NUM_BUILTIN

    def dispatch(self, handler_id, region: torch.Tensor,
                 payload: torch.Tensor) -> torch.Tensor:
        """Run handler ``handler_id`` on (region, payload) -> new region.

        ``handler_id`` is an int or a tensor of per-row IDs shaped like
        ``region.shape[:-1]``.  A tensor ID evaluates every entry and
        selects by ID with ``torch.where``, the way ``lax.switch``
        selects one branch per row; IDs are clipped into the table.
        """
        last = len(self._entries) - 1
        if not torch.is_tensor(handler_id):
            return self._entries[min(max(int(handler_id), 0), last)][1](
                region, payload)
        idx = handler_id.clamp(0, last)
        if idx.dim() == region.dim() - 1:
            idx = idx.unsqueeze(-1)
        out = self._entries[0][1](region, payload)
        for i, (_, fn) in enumerate(self._entries[1:], start=1):
            out = torch.where(idx == i, fn(region, payload), out)
        return out


DEFAULT_TABLE = HandlerTable()


def bump_credit(credits: torch.Tensor, token, n=1) -> torch.Tensor:
    """credits[k, token] += n on every kernel k (reply bookkeeping; paper
    Sec. III-A).  ``token`` and ``n`` are ints or ``(K,)`` tensors."""
    out = credits.clone()
    if torch.is_tensor(n):
        n = n.to(credits.dtype)
    if torch.is_tensor(token):
        rows = torch.arange(credits.shape[0], device=credits.device)
        out[rows, token.long()] += n
    else:
        out[:, int(token)] += n
    return out


def drain_credits(credits: torch.Tensor, token, n) -> torch.Tensor:
    """Consume ``n`` credits after a wait (GASNet wait-reply semantics)."""
    return bump_credit(credits, token, -n)
