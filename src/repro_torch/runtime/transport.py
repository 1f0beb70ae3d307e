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

:class:`LossyTransport` names a transport whose DCN links drop,
duplicate or corrupt packets.  This package has no reliability protocol
yet, so every op refuses a lossy transport at call time.  There is no
per-link latency/bandwidth model here: link costs of this package are
measured on the device, not modelled.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any


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


@dataclasses.dataclass(frozen=True)
class LossyTransport(Transport):
    """A transport whose links drop, duplicate or corrupt packets.

    ``faults`` is the fault model: any object with a ``lossless``
    property (true when every probability is zero).  The op layer has
    no reliability protocol yet and refuses a lossy transport; the
    per-link-class fault placement and retransmit bound of the JAX
    package arrive with that protocol.
    """

    name: str = "lossy-tcp"
    acked: bool = True
    faults: Any = None  # required; keyword-only in practice

    def __post_init__(self):
        if self.faults is None:
            raise ValueError("LossyTransport needs a fault model "
                             "(faults=... with a `lossless` property)")


def is_lossy(transport: Transport) -> bool:
    """Does this transport carry a fault model the op layer must defend
    against?  (A LossyTransport whose model is all-zero is lossless.)"""
    return (isinstance(transport, LossyTransport)
            and not transport.faults.lossless)
