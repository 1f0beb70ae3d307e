"""Plain PyTorch versions of the ring kernels in ``csrc/gascore_dma.cu``.

They compute what the kernel computes, on any device, add for add in
the reference's order and rounding to the input's type after every add,
so the kernels' sums differ in their last bits exactly as on the TPU.
The wrappers in :mod:`repro_torch.kernels.gascore_dma.ops` take them for
CPU tensors only.  The leading axis is the kernel axis: ``K = n``
kernels on a ring, kernel ``k`` putting to kernel ``(k + 1) % n``.  One
ring step is ``roll(1)`` along that axis.
"""

from __future__ import annotations

import torch

# the ring kernel's schedules (argument ``schedule`` of its wrappers)
DMA = "dma"
REDUCE_SCATTER = "reduce_scatter"
ALL_GATHER = "all_gather"
ALL_REDUCE = "all_reduce"


def ring_allreduce_dma_ref(x: torch.Tensor) -> torch.Tensor:
    """``_ring_kernel``'s schedule over ``x (K, ...)``: ``o = x``,
    ``carry = x``, then ``K - 1`` steps of ``carry <- carry of the left
    neighbour`` and ``o <- o + carry``.  Kernel ``k`` ends with
    ``((x[k] + x[k-1]) + x[k-2]) + ...``."""
    o, carry = x.clone(), x
    for _ in range(x.shape[0] - 1):
        carry = carry.roll(1, dims=0)
        o = o + carry
    return o


def ring_reduce_scatter_ref(buf: torch.Tensor) -> torch.Tensor:
    """``collectives.ring_reduce_scatter`` over ``buf (K, n, chunk)``,
    every kernel's addend cut into ``n = K`` chunks.  Step ``t``: kernel
    ``k`` sends chunk ``(k - t - 1) % n`` to its right and adds what its
    left sent onto its own chunk ``(k - t - 2) % n`` (``cur + recv``).
    Returns ``(K, chunk)``: kernel ``k``'s reduced chunk ``k``."""
    n = buf.shape[0]
    buf = buf.clone()
    ks = torch.arange(n, device=buf.device)
    for t in range(n - 1):
        recv = buf[ks, (ks - t - 1) % n].roll(1, dims=0)
        r = (ks - t - 2) % n
        buf[ks, r] = buf[ks, r] + recv
    return buf[ks, ks]


def ring_all_gather_ref(chunk: torch.Tensor) -> torch.Tensor:
    """``collectives.ring_all_gather`` over ``chunk (K, c)``: kernel
    ``k`` starts with its own chunk in row ``k``; step ``t`` sends row
    ``(k - t) % n`` to the right and overwrites row ``(k - t - 1) % n``
    with what arrived.  Returns ``(K, n, c)``, every kernel's rows in
    kernel order."""
    n, c = chunk.shape
    ks = torch.arange(n, device=chunk.device)
    buf = chunk.new_zeros((n, n, c))
    buf[ks, ks] = chunk
    for t in range(n - 1):
        buf[ks, (ks - t - 1) % n] = buf[ks, (ks - t) % n].roll(1, dims=0)
    return buf


def ring_collective_ref(x: torch.Tensor, schedule: str) -> torch.Tensor:
    """The ring collective ``schedule`` of ``collectives.py``:
    ``reduce_scatter`` ``(K, n, c) -> (K, c)``, ``all_gather``
    ``(K, c) -> (K, n, c)``, ``all_reduce`` (the two in sequence)
    ``(K, n, c) -> (K, n, c)``."""
    if schedule == REDUCE_SCATTER:
        return ring_reduce_scatter_ref(x)
    if schedule == ALL_GATHER:
        return ring_all_gather_ref(x)
    if schedule == ALL_REDUCE:
        return ring_all_gather_ref(ring_reduce_scatter_ref(x))
    raise ValueError(f"unknown ring collective schedule {schedule!r}")
