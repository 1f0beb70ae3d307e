"""Galapagos-analogue runtime of the PyTorch port: topology, transports,
routing.

* :mod:`repro_torch.runtime.topology`  -- the cluster description (pods x
  chips) and kernel placement; the analogue of Galapagos' cluster files.
* :mod:`repro_torch.runtime.transport` -- delivery semantics (acked vs
  async, packet-size limits, lossy links); the analogue of choosing
  TCP/UDP in the Galapagos middleware layer.
* :mod:`repro_torch.runtime.router`    -- kernel-ID <-> coordinate mapping
  and link classification (same kernel / intra-pod ICI / inter-pod DCN).
"""

from repro_torch.runtime.router import Router
from repro_torch.runtime.topology import (ClusterSpec, kernel_coords,
                                          neighbors_ring, pairwise, pod_of)
from repro_torch.runtime.transport import (TCP, UDP, LinkClass,
                                           LossyTransport, Transport,
                                           default_link_of, is_lossy)

__all__ = [
    "ClusterSpec",
    "kernel_coords",
    "pod_of",
    "neighbors_ring",
    "pairwise",
    "Transport",
    "LossyTransport",
    "TCP",
    "UDP",
    "LinkClass",
    "default_link_of",
    "is_lossy",
    "Router",
]
