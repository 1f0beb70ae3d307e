"""Hand-written Hopper kernels of the PyTorch port, each beside its plain
PyTorch version (``ref.py``) and a wrapper (``ops.py``) that launches
the kernel on CUDA tensors and runs the plain version on CPU tensors:

* ``am_pack`` -- the GAScore's DataMover: header-driven gather (packet
  egress, get service) and in-order scatter with the built-in handlers
  (Long ingress), replacing ``am_pack_pallas``/``am_unpack_pallas``: a
  Hopper design (a gather tiled over the card with every load in
  flight, a scatter that applies the words one block owns in parallel
  and walks the blocks in order only where they meet; 32- and 16-bit
  words) and the simple design, chosen by ``datamover_kernel_for``.
* ``jacobi``  -- the paper's stencil hot loop (Sec. IV-C), full-grid and
  banded forms, replacing ``jacobi_step_pallas``.
* ``gascore_dma`` -- the GAScore's RDMA ring: ring all-reduce by
  one-sided puts with ADD on arrival, and the ring reduce-scatter /
  all-gather / all-reduce schedules of ``core.collectives``, replacing
  ``ring_allreduce_dma_local``: a Hopper kernel (a thread-block cluster,
  one CTA per Shoal kernel, DSMEM puts, mbarrier semaphores) for
  2 <= K <= 8, and a simple kernel for every other K it holds.
* ``attention`` -- causal flash attention over a prompt (GQA layout),
  the LM stack's prefill and forward, replacing ``flash_attention_pallas``:
  a Hopper kernel (TMA tile ring, ``wgmma``) for bfloat16 at head dim 64
  and 128, and a simple kernel for every other input it holds (MLA's
  q·k head dim 192 with v head dim 128 among them).

CUDA sources live under each kernel's ``csrc/`` and are compiled with
``nvcc`` at first use (:mod:`repro_torch.kernels._build`).
"""

from repro_torch.kernels.am_pack.am_pack import (launch_gather,
                                                 launch_gather_sm90,
                                                 launch_scatter,
                                                 launch_scatter_sm90)
from repro_torch.kernels.attention.flash import (flash_attention_cuda,
                                                 launch_flash_sm90)
from repro_torch.kernels.gascore_dma.gascore_dma import (
    launch_ring_sm90, ring_allreduce_dma_cuda, ring_collective_cuda)
from repro_torch.kernels.jacobi.jacobi import jacobi_sweep_cuda

# every kernel wrapper that counts its launches, by kernel name
LAUNCH_COUNTERS = {
    "datamover_gather": launch_gather,              # the simple design
    "datamover_scatter": launch_scatter,            # the simple design
    "datamover_gather_sm90": launch_gather_sm90,    # the Hopper design
    "datamover_scatter_sm90": launch_scatter_sm90,  # the Hopper design
    "jacobi_sweep": jacobi_sweep_cuda,
    "ring_allreduce_dma": ring_allreduce_dma_cuda,  # either ring kernel
    "ring_collective": ring_collective_cuda,        # either ring kernel
    "ring_cluster_sm90": launch_ring_sm90,          # the cluster kernel
    "flash_attention": flash_attention_cuda,        # either flash kernel
    "flash_attention_sm90": launch_flash_sm90,      # the Hopper kernel
}


def launch_counts() -> dict[str, int]:
    """Launches of every kernel so far, by kernel name."""
    return {name: fn.launches for name, fn in LAUNCH_COUNTERS.items()}


def reset_launch_counts() -> None:
    for fn in LAUNCH_COUNTERS.values():
        fn.launches = 0
