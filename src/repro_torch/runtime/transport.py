"""Transports: the Galapagos middleware-layer analogue.

The paper's middleware lets an application switch between TCP, UDP and
raw Ethernet without source changes (Sec. II-B2), and its AM layer marks
messages *asynchronous* to suppress the automatic reply (Sec. III-A):

* ``TCP``  -> *acked* delivery: every AM triggers an automatic reply
  that bumps a credit counter at the source (2 link traversals).
* ``UDP``  -> *async* delivery: fire-and-forget (1 link traversal).

A transport also carries the maximum packet size.  The paper inherits a
9000-byte jumbo-frame limit from the hardware TCP core and leaves
segmentation of larger AMs as future work (footnote 2); the op layer
(:mod:`repro_torch.core.ops`) implements that segmentation, governed by
``max_packet_bytes`` here.

:class:`LossyTransport` names a transport whose lossy link classes
(by default only DCN: LOCAL and ICI stay reliable) drop, duplicate or
corrupt packets, by a seedable :class:`repro_torch.core.faults.FaultModel`
applied receiver-side at the exchange.  On an *acked* lossy transport
``put_long`` seals every packet with the header CRC word, stamps a send
epoch and retransmits up to ``max_retries`` rounds; the receiver's dedup
ledger keyed on (token, epoch, seq) makes redelivery idempotent, and a
sender that exhausts its retries latches ``ERR_RETRY_EXHAUSTED``.  Every
other op refuses a lossy transport.  There is no per-link
latency/bandwidth model here: link costs of this package are measured on
the device, not modelled.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable


class LinkClass(enum.Enum):
    """The three placement classes of the paper's six topologies.

    Paper (FPGA cluster)              -> accelerator cluster
    same node (internal routing)      -> LOCAL (same device, no exchange)
    different nodes, HW fast path     -> ICI (intra-pod link)
    different nodes via full stack    -> DCN (data-center network)
    """

    LOCAL = 0
    ICI = 1
    DCN = 2


@dataclasses.dataclass(frozen=True)
class Transport:
    """Delivery semantics + packet limits."""

    name: str
    acked: bool                      # TCP-like auto-reply vs UDP-like async
    max_packet_bytes: int = 9000     # jumbo frame, as in the paper
    word_bytes: int = 4              # one Shoal word = one f32/int32

    @property
    def max_packet_words(self) -> int:
        return self.max_packet_bytes // self.word_bytes

    def hops_per_message(self) -> int:
        """Link traversals per AM: 1 for the message, +1 for the reply."""
        return 2 if self.acked else 1


TCP = Transport(name="tcp", acked=True)
UDP = Transport(name="udp", acked=False)


def default_link_of(src: int, dst: int) -> LinkClass:
    """Pessimistic default placement: same kernel id = LOCAL, everything
    else crosses the data-center network.  Clusters with a real topology
    map pass their own classifier (e.g. :meth:`repro_torch.runtime.router.
    Router.classify`) to :class:`LossyTransport`."""
    return LinkClass.LOCAL if src == dst else LinkClass.DCN


@dataclasses.dataclass(frozen=True)
class LossyTransport(Transport):
    """A transport whose lossy link classes drop/duplicate/corrupt.

    ``faults`` is the seedable fault process (a
    :class:`repro_torch.core.faults.FaultModel`) applied to every link
    whose :class:`LinkClass` is in ``lossy_links`` (default: only DCN);
    ``link_of(src, dst)`` classifies a link.  On an *acked* lossy
    transport ``put_long`` runs the reliable put: CRC-sealed packets,
    receiver-side dedup, and up to ``max_retries`` retransmissions driven
    by the missing ack before latching ``ERR_RETRY_EXHAUSTED``.  On an
    async lossy transport messages stay fire-and-forget.
    """

    name: str = "lossy-tcp"
    acked: bool = True
    faults: Any = None  # required; keyword-only in practice
    lossy_links: tuple[LinkClass, ...] = (LinkClass.DCN,)
    link_of: Callable[[int, int], LinkClass] = default_link_of
    max_retries: int = 4

    def __post_init__(self):
        if self.faults is None:
            raise ValueError("LossyTransport needs a FaultModel "
                             "(use faults=FaultModel(...))")
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")

    def link_is_lossy(self, src: int, dst: int) -> bool:
        return self.link_of(src, dst) in self.lossy_links

    def probs_for(self, src: int, dst: int) -> tuple[float, float, float]:
        """(drop, dup, corrupt) probabilities of the (src, dst) link."""
        if self.link_is_lossy(src, dst):
            return (self.faults.drop, self.faults.dup, self.faults.corrupt)
        return (0.0, 0.0, 0.0)


def is_lossy(transport: Transport) -> bool:
    """Does this transport carry a fault model the op layer must defend
    against?  (A LossyTransport whose model is all-zero is lossless.)"""
    return (isinstance(transport, LossyTransport)
            and not transport.faults.lossless)
