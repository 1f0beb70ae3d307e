from repro_torch.kernels.gascore_dma.gascore_dma import (
    ClusterPlan, cluster_max_active, cluster_tile_plan, launch_ring_sm90,
    ring_allreduce_dma_cuda, ring_collective_cuda, ring_kernel_for,
    tile_plan)
from repro_torch.kernels.gascore_dma.ops import (ring_allreduce_dma,
                                                 ring_collective)
from repro_torch.kernels.gascore_dma.ref import (
    ALL_GATHER, ALL_REDUCE, DMA, REDUCE_SCATTER, ring_all_gather_ref,
    ring_allreduce_dma_ref, ring_collective_ref, ring_reduce_scatter_ref)

__all__ = ["ring_allreduce_dma", "ring_collective",
           "ring_allreduce_dma_ref", "ring_collective_ref",
           "ring_reduce_scatter_ref", "ring_all_gather_ref",
           "ring_allreduce_dma_cuda", "ring_collective_cuda", "tile_plan",
           "ring_kernel_for", "cluster_tile_plan", "cluster_max_active",
           "launch_ring_sm90", "ClusterPlan",
           "DMA", "REDUCE_SCATTER", "ALL_GATHER", "ALL_REDUCE"]
