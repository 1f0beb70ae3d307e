"""Galapagos-analogue runtime of the PyTorch port: transports.

* :mod:`repro_torch.runtime.transport` -- delivery semantics (acked vs
  async, packet-size limits); the analogue of choosing TCP/UDP in the
  Galapagos middleware layer.
"""

from repro_torch.runtime.transport import (TCP, UDP, LinkClass,
                                           LossyTransport, Transport,
                                           is_lossy)

__all__ = [
    "Transport",
    "LossyTransport",
    "TCP",
    "UDP",
    "LinkClass",
    "is_lossy",
]
