"""Deterministic, seedable packet-fault injection at the exchange.

The paper's middleware runs over transports that are allowed to lose
things (TCP / UDP / raw Ethernet, Sec. II-B2); the port's exchange is a
gather over the kernel axis, which never loses anything.  This module
injects the losses back, receiver-side, on the ``(K, nseg, W)`` int32
packet stack that just came out of the exchange:

* **drop** -- the row is zeroed.  An all-zero row is the wire's NOP, so
  a dropped packet is simply never seen, like a lost datagram.
* **corrupt** -- one uniformly chosen bit of the row (header or payload)
  is flipped.  The CRC seal (:func:`repro_torch.core.am.packet_crc_ok`)
  catches every single-bit flip; the receiver NOPs the row and latches
  ``ERR_CRC``, so corruption degenerates to drop + a sticky error bit.
* **duplicate** -- the row is delivered twice.  :func:`deliver` returns a
  ``(K, 2 * nseg, W)`` stack whose second half holds the duplicated rows
  (NOP elsewhere); the dedup ledger makes redelivery idempotent.

Only live rows (non-NOP type word) fault.  Probabilities are
per-receiver, so one exchange can mix lossless (LOCAL/ICI) and lossy
(DCN) links: a receiver on a lossless link passes 0 and nothing fires.

The draws are a pure function of ``(seed, receiver, token, epoch, round,
direction, row)``, never of a generator's state or of call order.  The
JAX package draws them with threefry keys, which torch cannot
reproduce; this package draws them from a stateless counter-based
integer hash (:func:`hash_draws`) in int64 tensor ops, which gives the
same bits on the CPU and on the card.  ``FaultModel(draws=...)`` plugs
in another source of the same shape (a test feeds the JAX package's own
draws through it).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from repro_torch.core import am

# direction salts: data stack vs the (reverse-link) ack
DIR_DATA = 0
DIR_REPLY = 1

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
_I_TYPE = am.FIELDS.index("type")


class Draws(NamedTuple):
    """One round's draws for ``(K, nseg)`` rows: three uniforms in
    ``[0, 1)`` (float32) compared against the drop / duplicate / corrupt
    probabilities, and the bit a corruption flips, in ``[0, 32 * W)``
    (int64)."""

    drop: torch.Tensor
    dup: torch.Tensor
    corrupt: torch.Tensor
    bit: torch.Tensor


# draws(receiver, token, epoch, rnd, direction, nseg, width) -> Draws, the
# first three (K,) tensors, the rest ints
DrawSource = Callable[..., Draws]


@dataclasses.dataclass(frozen=True)
class FaultModel:
    """Per-link-class fault process: independent per-packet Bernoulli
    draws for drop / duplicate / corrupt, derived from ``seed``
    (:func:`hash_draws`) unless ``draws`` gives another source."""

    drop: float = 0.0
    dup: float = 0.0
    corrupt: float = 0.0
    seed: int = 0
    draws: DrawSource | None = dataclasses.field(default=None,
                                                 compare=False, repr=False)

    def __post_init__(self):
        for name in ("drop", "dup", "corrupt"):
            p = getattr(self, name)
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"FaultModel.{name} must be in [0, 1], "
                                 f"got {p}")

    @property
    def lossless(self) -> bool:
        return self.drop == 0.0 and self.dup == 0.0 and self.corrupt == 0.0

    def draw(self, receiver: torch.Tensor, token: torch.Tensor,
             epoch: torch.Tensor, rnd: int, direction: int, nseg: int,
             width: int) -> Draws:
        """The draws of one round on every receiver."""
        if self.draws is not None:
            return self.draws(receiver, token, epoch, rnd, direction, nseg,
                              width)
        return hash_draws(self.seed, receiver, token, epoch, rnd, direction,
                          nseg, width)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for ``x`` in ``[0, 2**32)`` held in int64,
    in two 16-bit halves so no product leaves int64."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer finaliser (lowbias32) on int64 tensors."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _fold(h: torch.Tensor, salt) -> torch.Tensor:
    if torch.is_tensor(salt):
        salt = salt.to(torch.int64)
    return _mix(((h ^ (salt & _M32)) + _GOLDEN) & _M32)


def hash_draws(seed: int, receiver: torch.Tensor, token: torch.Tensor,
               epoch: torch.Tensor, rnd: int, direction: int, nseg: int,
               width: int) -> Draws:
    """The default draws: a counter-based hash of ``(seed, receiver,
    token, epoch, rnd, direction)`` folded with each row index and each
    of the four streams.  ``receiver``, ``token`` and ``epoch`` are
    ``(K,)`` tensors; the result's fields are ``(K, nseg)``.  A uniform
    is the hash's top 24 bits over ``2**24`` (exact in float32)."""
    dev = receiver.device
    h = torch.full(receiver.shape, seed & _M32, dtype=torch.int64,
                   device=dev)
    h = _mix(h)
    for salt in (receiver, token, epoch, rnd, direction):
        h = _fold(h, salt)
    rows = torch.arange(nseg, dtype=torch.int64, device=dev)
    h = _fold(h[:, None], rows)
    u = [(_fold(h, s) >> 8).to(torch.float32) * (1.0 / (1 << 24))
         for s in range(3)]
    bit = _fold(h, 3) % (32 * width)
    return Draws(u[0], u[1], u[2], bit)


def _per_row(p, like: torch.Tensor):
    """A per-receiver probability ``(...)`` as a ``(..., 1)`` column
    against ``(..., nseg)`` draws; floats pass through."""
    if torch.is_tensor(p):
        return p.to(torch.float32).reshape(p.shape + (1,))
    return p


def inject(rows: torch.Tensor, draws: Draws, drop, dup, corrupt):
    """Apply one round of faults to a received ``(..., nseg, W)`` int32
    stack.  ``drop`` / ``dup`` / ``corrupt`` are floats or per-receiver
    ``(...)`` tensors (0 on lossless links); ``draws`` fields are
    ``(..., nseg)``.  Returns ``(rows_after, dup_mask)``: corrupt flips
    bit ``b % 32`` of lane ``b // 32``, drop zeroes the row
    (corrupt-then-drop: a packet both corrupted and lost is just lost),
    ``dup_mask`` marks surviving rows delivered twice.  Only live
    (non-NOP) rows fault."""
    width = rows.shape[-1]
    live = rows[..., _I_TYPE] != 0
    dropm = live & (draws.drop < _per_row(drop, rows))
    dupm = live & (draws.dup < _per_row(dup, rows))
    corm = live & (draws.corrupt < _per_row(corrupt, rows))
    lane = torch.arange(width, device=rows.device)
    bit = draws.bit.to(torch.int64)
    flip = torch.where(lane == (bit // 32)[..., None],
                       torch.ones_like(bit)[..., None] << (bit % 32)[..., None],
                       0)
    flip = torch.where(flip >= 1 << 31, flip - (1 << 32), flip).to(torch.int32)
    rows = torch.where(corm[..., None], rows ^ flip, rows)
    rows = torch.where(dropm[..., None], 0, rows)
    return rows, dupm & ~dropm


def deliver(rows: torch.Tensor, draws: Draws, drop, dup, corrupt):
    """Full receiver-side delivery: fault the stack and materialise
    duplicates.  Returns a ``(..., 2 * nseg, W)`` stack -- faulted rows
    first, then the duplicated rows (NOP where no duplicate fired) --
    ready for the dedup-gated ingress."""
    faulted, dupm = inject(rows, draws, drop, dup, corrupt)
    dups = torch.where(dupm[..., None], faulted, 0)
    return torch.cat([faulted, dups], dim=-2)
