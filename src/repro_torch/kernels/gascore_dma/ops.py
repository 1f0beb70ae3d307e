"""Ring wrappers: the CUDA kernel for CUDA tensors, the plain version for
CPU tensors, and nothing else (no fallback)."""

from __future__ import annotations

import torch

from repro_torch.kernels.gascore_dma.gascore_dma import (
    ring_allreduce_dma_cuda, ring_collective_cuda)
from repro_torch.kernels.gascore_dma.ref import (ring_allreduce_dma_ref,
                                                 ring_collective_ref)


def ring_allreduce_dma(x: torch.Tensor) -> torch.Tensor:
    """The GAScore's RDMA ring all-reduce over ``x (K, chunk)``, one row
    per kernel: every row becomes the sum of all rows, added in the ring
    order of the TPU kernel.  The counterpart of the JAX package's
    ``ring_allreduce_dma(mesh, axis, x)``: the kernel axis replaces the
    mesh."""
    if x.device.type == "cpu":
        return ring_allreduce_dma_ref(x)
    return ring_allreduce_dma_cuda(x)


def ring_collective(x: torch.Tensor, schedule: str) -> torch.Tensor:
    """One ring collective of ``collectives.py`` over the kernel axis
    (see :func:`..ref.ring_collective_ref` for the schedules)."""
    if x.device.type == "cpu":
        return ring_collective_ref(x, schedule)
    return ring_collective_cuda(x, schedule)
