"""Routing: kernel IDs <-> cluster coordinates and link classification.

libGalapagos routes packets between local kernels in software and hands
off-node traffic to the network driver.  Here traffic whose source and
destination are the same kernel is LOCAL (no exchange), traffic inside
a pod crosses ICI, and traffic between pods crosses DCN -- the link
class a :class:`~repro_torch.runtime.transport.LossyTransport` faults.
"""

from __future__ import annotations

import dataclasses

from repro_torch.runtime.topology import ClusterSpec, kernel_coords, pod_of
from repro_torch.runtime.transport import LinkClass


@dataclasses.dataclass(frozen=True)
class Router:
    spec: ClusterSpec

    def classify(self, src: int, dst: int) -> LinkClass:
        """Which link class a src->dst AM traverses."""
        if src == dst:
            return LinkClass.LOCAL
        if pod_of(self.spec, src) != pod_of(self.spec, dst):
            return LinkClass.DCN
        return LinkClass.ICI

    def classify_pattern(self, pattern: list[tuple[int, int]]) -> LinkClass:
        """Worst link class over a pattern (a mixed pattern is bounded by
        its slowest hop)."""
        worst = LinkClass.LOCAL
        for s, d in pattern:
            c = self.classify(s, d)
            if c.value > worst.value:
                worst = c
        return worst

    def coords(self, kernel_id: int) -> dict[str, int]:
        return kernel_coords(self.spec, kernel_id)

    def is_pure_local(self, pattern: list[tuple[int, int]]) -> bool:
        return all(s == d for s, d in pattern)
