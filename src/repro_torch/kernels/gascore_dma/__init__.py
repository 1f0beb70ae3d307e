from repro_torch.kernels.gascore_dma.gascore_dma import (
    ring_allreduce_dma_cuda, ring_collective_cuda, tile_plan)
from repro_torch.kernels.gascore_dma.ops import (ring_allreduce_dma,
                                                 ring_collective)
from repro_torch.kernels.gascore_dma.ref import (
    ALL_GATHER, ALL_REDUCE, DMA, REDUCE_SCATTER, ring_all_gather_ref,
    ring_allreduce_dma_ref, ring_collective_ref, ring_reduce_scatter_ref)

__all__ = ["ring_allreduce_dma", "ring_collective",
           "ring_allreduce_dma_ref", "ring_collective_ref",
           "ring_reduce_scatter_ref", "ring_all_gather_ref",
           "ring_allreduce_dma_cuda", "ring_collective_cuda", "tile_plan",
           "DMA", "REDUCE_SCATTER", "ALL_GATHER", "ALL_REDUCE"]
