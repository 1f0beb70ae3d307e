"""Shoal: a PGAS Active-Message communication library, PyTorch port.

The N Shoal kernels are a leading kernel axis on one device; a link
traversal is a gather over that axis.  Public surface:

* :mod:`repro_torch.core.am`            -- AM wire format (Short/Medium/
  Long, put/get, FIFO/memory, strided, async flag, CRC seal).
* :mod:`repro_torch.core.handlers`      -- receiver-side handler table +
  credits.
* :mod:`repro_torch.core.gascore`       -- the AM engine (ingress/egress
  datapaths on the DataMover kernels; the GAScore of Fig. 3).
* :mod:`repro_torch.core.ops`           -- the user API: puts (vectored,
  and reliable over a lossy transport)/gets/barrier/wait.
* :mod:`repro_torch.core.faults`        -- seedable drop/duplicate/
  corrupt injection at the exchange (lossy links).
* :mod:`repro_torch.core.collectives`   -- ring reduce-scatter/all-gather/
  all-reduce on the ring kernel, broadcast, all-to-all, barrier.
* :mod:`repro_torch.core.humboldt`      -- two-sided 4-phase baseline.
* :mod:`repro_torch.core.address_space` -- the partitioned global
  address space.
"""

from repro_torch.core import (am, collectives, faults, gascore, handlers,
                              humboldt, ops)
from repro_torch.core.address_space import GlobalAddressSpace
from repro_torch.core.state import PgasState, ShoalContext

__all__ = [
    "am", "collectives", "faults", "gascore", "handlers", "humboldt", "ops",
    "GlobalAddressSpace", "PgasState", "ShoalContext",
]
