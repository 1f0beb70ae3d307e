"""Per-kernel PGAS state and the Shoal context of the PyTorch port.

``PgasState`` is what the GAScore / handler thread owns per kernel in
the paper: the shared-memory segment (this kernel's partition of the
global address space), the reply/credit counter file, and counters for
the Table-I-style cost accounting.  The N Shoal kernels are a leading
kernel axis ``K`` on one device, so every leaf is ``(K, ...)``.  Ops
take a state and return a new one; the input state is not modified.

``ShoalContext`` is the configuration: the number of kernels, the
transport (acked/async + packet limit), the handler table, the segment
size and the device.  It also counts the link traversals the program
makes (``exchanges``): one per kernel-axis gather, the counterpart of a
collective-permute in the compiled program of the JAX package; and the
collective calls of :mod:`repro_torch.core.collectives` by kind
(``collectives``), one per call, as the compiled program counts one
all-to-all, all-reduce, all-gather or reduce-scatter op per collective,
and the bytes of their ring-kernel launches by kind (``ring_bytes``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, NamedTuple

import numpy as np
import torch

from repro_torch.core import handlers as hd
from repro_torch.runtime.transport import TCP, Transport


@dataclasses.dataclass
class PgasState:
    """Per-kernel runtime state; every leaf is ``(K, ...)``."""

    segment: torch.Tensor          # (K, segment_words) shared-memory partition
    credits: torch.Tensor          # (K, NUM_TOKENS) int32 reply counters
    barrier_epoch: torch.Tensor    # (K,) int32
    rx_words: torch.Tensor         # (K,) int32 total words received
    tx_words: torch.Tensor         # (K,) int32 total words sent
    error: torch.Tensor            # (K,) int32 sticky error bits
    deferred_acks: torch.Tensor    # (K, NUM_TOKENS) int32 acks owed per link
    # deferred_acks is the receiver-side piggyback ledger: a put flagged
    # FLAG_DEFER_ACK bumps deferred_acks[token] here instead of shipping
    # a reply exchange; the next packet this kernel sends over the
    # reverse link carries the count home in its pb_token/pb_count lane.

    # lossy-transport reliability state (the reliable put_long): per-
    # (sender, token) send epochs, the receiver's redelivery ledger and
    # the retry counter.
    send_epoch: torch.Tensor       # (K, NUM_TOKENS) int32
    dedup_epoch: torch.Tensor      # (K, NUM_TOKENS) int32
    dedup_inflight: torch.Tensor   # (K, NUM_TOKENS) int32
    dedup_seen: torch.Tensor       # (K, NUM_TOKENS) int32
    retransmits: torch.Tensor      # (K,) int32

    @staticmethod
    def make(num_kernels: int, segment_words: int, dtype=torch.float32,
             device=None) -> "PgasState":
        """A zero state on ``device`` (default: the CUDA card)."""
        device = resolve_device(device)

        def z(*shape, dt=torch.int32):
            return torch.zeros((num_kernels,) + shape, dtype=dt,
                               device=device)

        return PgasState(
            segment=z(segment_words, dt=dtype),
            credits=z(hd.NUM_TOKENS),
            barrier_epoch=z(),
            rx_words=z(),
            tx_words=z(),
            error=z(),
            deferred_acks=z(hd.NUM_TOKENS),
            send_epoch=z(hd.NUM_TOKENS),
            dedup_epoch=z(hd.NUM_TOKENS),
            dedup_inflight=z(hd.NUM_TOKENS),
            dedup_seen=z(hd.NUM_TOKENS),
            retransmits=z(),
        )


FIELDS = tuple(f.name for f in dataclasses.fields(PgasState))


def replace(state: PgasState, **kw) -> PgasState:
    """A copy of ``state`` with the given leaves swapped."""
    return dataclasses.replace(state, **kw)


def state_from_numpy(arrays: Mapping[str, np.ndarray],
                     device=None) -> PgasState:
    """Build a state on ``device`` (default: the CUDA card) from numpy
    ``(K, ...)`` leaves keyed by field name (e.g. a stacked global state
    of the JAX package read back to the host).  Every field must be
    present."""
    device = resolve_device(device)
    missing = set(FIELDS) - set(arrays)
    if missing:
        raise ValueError(f"state_from_numpy: missing fields {sorted(missing)}")
    return PgasState(**{
        f: torch.from_numpy(np.array(arrays[f], copy=True)).to(device)
        for f in FIELDS})


def state_to_numpy(state: PgasState) -> dict[str, np.ndarray]:
    """The state's leaves as numpy ``(K, ...)`` arrays keyed by field."""
    return {f: getattr(state, f).detach().cpu().numpy() for f in FIELDS}


# -- sticky error bits + host-side decode registry ---------------------------
ERR_WAIT_UNDERFLOW = 1    # wait_replies saw fewer credits than expected
ERR_CRC = 2               # a received packet failed its CRC seal
ERR_RETRY_EXHAUSTED = 4   # a reliable put ran out of retransmit rounds


class ShoalError(RuntimeError):
    """Base of host-side errors decoded from the sticky device error
    word.  ``kernels`` names the kernels that latched the bit."""

    def __init__(self, message: str, kernels=()):
        self.kernels = tuple(int(k) for k in kernels)
        super().__init__(message)


class WaitUnderflowError(ShoalError):
    """A ``wait_replies`` drained more credits than the schedule issued.

    The error word is sticky (device code cannot raise), so
    :func:`raise_on_error` decodes the bit and names the offending
    token(s): a drained wait leaves its token's credit counter negative.
    """

    def __init__(self, tokens, kernels, where: str = ""):
        self.tokens = tuple(int(t) for t in tokens)
        at = f" in {where}" if where else ""
        tok = (f"token(s) {list(self.tokens)}" if self.tokens
               else "an unidentified token (counters were rebalanced)")
        kernels = tuple(int(k) for k in kernels)
        ker = f" on kernel(s) {list(kernels)}" if kernels else ""
        super().__init__(
            f"ERR_WAIT_UNDERFLOW{at}: wait_replies consumed more credits "
            f"than were issued on {tok}{ker} — the threaded original "
            "would hang here; shoal-lint rule R3 names this schedule "
            "from a recorded run (repro_torch.analysis.lint, "
            "scripts/torch_comm_lint.py)", kernels)


class CrcError(ShoalError):
    """A receiver saw a packet whose CRC seal failed."""


class RetryExhaustedError(ShoalError):
    """A reliable put gave up after ``max_retries`` retransmissions."""


def _build_wait_underflow(state, kernels, where):
    credits = state.credits.detach().cpu().numpy().reshape(-1, hd.NUM_TOKENS)
    # an over-drained wait leaves its token negative on the waiting kernel
    tokens = np.nonzero((credits < 0).any(axis=0))[0]
    return WaitUnderflowError(tokens, kernels, where=where)


def _generic_builder(name, exc):
    def build(state, kernels, where):
        kernels = tuple(int(k) for k in kernels)
        at = f" in {where}" if where else ""
        ker = f" on kernel(s) {list(kernels)}" if kernels else ""
        return exc(f"{name}{at}: sticky device error bit latched{ker} "
                   "(see repro_torch.core.state docs for semantics)",
                   kernels)
    return build


# bit -> (name, exception class, builder(state, kernels, where) -> exc)
ERROR_BITS: dict[int, tuple[str, type, Any]] = {}


def register_error_bit(bit: int, name: str, exc: type = ShoalError,
                       builder=None) -> None:
    """Register a sticky error bit so :func:`raise_on_error` can decode
    and name it.  ``bit`` must be a fresh power of two."""
    if bit <= 0 or bit & (bit - 1):
        raise ValueError(f"error bit must be a power of two, got {bit}")
    if bit in ERROR_BITS:
        raise ValueError(f"error bit {bit} already registered "
                         f"as {ERROR_BITS[bit][0]}")
    ERROR_BITS[bit] = (name, exc, builder or _generic_builder(name, exc))


register_error_bit(ERR_WAIT_UNDERFLOW, "ERR_WAIT_UNDERFLOW",
                   WaitUnderflowError, _build_wait_underflow)
register_error_bit(ERR_CRC, "ERR_CRC", CrcError)
register_error_bit(ERR_RETRY_EXHAUSTED, "ERR_RETRY_EXHAUSTED",
                   RetryExhaustedError)


def error_names(err: int) -> tuple[str, ...]:
    """Names of the registered bits set in an error word."""
    return tuple(name for bit, (name, _, _) in sorted(ERROR_BITS.items())
                 if err & bit)


def raise_on_error(state: PgasState, *, where: str = "",
                   ignore: int = 0) -> PgasState:
    """Host-side check: raise if any kernel latched an error bit.

    Every registered bit is decoded to its named exception class, lowest
    bit first; ``ignore`` masks bits the caller expects.  Returns
    ``state`` unchanged when clean.
    """
    err = state.error.detach().cpu().numpy().reshape(-1)
    pending = int(np.bitwise_or.reduce(err)) & ~ignore if err.size else 0
    for bit, (name, _, build) in sorted(ERROR_BITS.items()):
        if pending & bit:
            kernels = np.nonzero(err & bit)[0] if err.size > 1 else ()
            raise build(state, kernels, where)
    if pending:
        raise ShoalError(f"unregistered error bit(s) 0x{pending:x}"
                         + (f" in {where}" if where else ""))
    return state


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; without one this raises rather than
    running on the CPU.  Pass ``"cpu"`` to run on the CPU on purpose."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


class PatternTable(NamedTuple):
    """Device-side tables of one communication pattern."""

    sender: torch.Tensor      # (K,) bool: does kernel k send?
    dst: torch.Tensor         # (K,) int32 destination of kernel k, or -1
    srcs: torch.Tensor        # (P,) int64 sources, pattern order
    dsts: torch.Tensor        # (P,) int64 destinations, pattern order


# the collective kinds ``ShoalContext.collectives`` counts (the JAX
# package's HLO op kinds, as ``comm_budgets.toml`` keys them)
COLLECTIVE_KINDS = ("all_to_all", "all_reduce", "all_gather",
                    "reduce_scatter")


class ShoalContext:
    """Shoal configuration over ``num_kernels`` kernels on one device.

    Attributes:
      num_kernels: kernels on the leading axis of every state leaf.
      transport: delivery semantics + packet limit (TCP/UDP analogue).
      segment_words: words in each kernel's segment.
      device: where states and packets live (default: the CUDA card).
      handlers: the handler table.
      exchanges: link traversals made so far (kernel-axis gathers).
      collectives: collective calls made so far, by kind
        (:data:`COLLECTIVE_KINDS`).
      ring_bytes: bytes of the ring-kernel launches made so far, by the
        same kinds: each launch's stacked input read once and its output
        written once (``all_to_all`` runs no ring launch and stays 0).
    """

    def __init__(self, num_kernels: int, transport: Transport = TCP,
                 segment_words: int = 4096, device=None,
                 handlers: hd.HandlerTable | None = None):
        if num_kernels < 1:
            raise ValueError(f"num_kernels must be >= 1, got {num_kernels}")
        self.num_kernels = int(num_kernels)
        self.transport = transport
        self.segment_words = int(segment_words)
        self.device = resolve_device(device)
        self.handlers = hd.DEFAULT_TABLE if handlers is None else handlers
        self.exchanges = 0
        self.collectives = dict.fromkeys(COLLECTIVE_KINDS, 0)
        self.ring_bytes = dict.fromkeys(COLLECTIVE_KINDS, 0)
        self._patterns: dict[tuple, PatternTable] = {}

    def my_id(self) -> torch.Tensor:
        """Kernel IDs along the kernel axis: ``arange(K)``."""
        return torch.arange(self.num_kernels, dtype=torch.int32,
                            device=self.device)

    def make_state(self, dtype=torch.float32) -> PgasState:
        return PgasState.make(self.num_kernels, self.segment_words, dtype,
                              self.device)

    def mailbox(self, pattern, **kw):
        """Per-destination coalescing mailbox over this context (the
        actor layer, :mod:`repro_torch.actors`): N tiny sends along
        ``pattern`` flush as ONE exchange."""
        from repro_torch.actors import Mailbox  # deferred: actors imports core

        return Mailbox(self, pattern, **kw)

    def reply_mailbox(self):
        """Deferred-ack mailbox: pass as ``reply_via=`` to put ops so
        their acks coalesce into one Short AM per destination at
        flush."""
        from repro_torch.actors import ReplyMailbox  # deferred: actors imports core

        return ReplyMailbox(self)

    def pattern(self, pattern) -> PatternTable:
        """The device tables of ``pattern`` (``(src, dst)`` pairs), built
        once per context so a loop over the same pattern copies nothing
        to the device.  A pattern must be a partial permutation: each
        kernel sends at most one packet and receives at most one."""
        key = tuple((int(s), int(d)) for s, d in pattern)
        table = self._patterns.get(key)
        if table is None:
            srcs = [s for s, _ in key]
            dsts = [d for _, d in key]
            if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
                raise ValueError(
                    f"pattern {list(key)} is not a permutation: each kernel "
                    "may send at most one packet and receive at most one")
            dst = [-1] * self.num_kernels
            for s, d in key:
                dst[s] = d
            dev = self.device
            table = PatternTable(
                sender=torch.tensor([d >= 0 for d in dst], device=dev),
                dst=torch.tensor(dst, dtype=torch.int32, device=dev),
                srcs=torch.tensor(srcs, dtype=torch.int64, device=dev),
                dsts=torch.tensor(dsts, dtype=torch.int64, device=dev))
            self._patterns[key] = table
        return table
