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
* ``attention`` -- flash attention (GQA layout), causal over a prompt
  (the LM stack's prefill and forward) or over every key of a sequence
  of its own (cross-attention's prompt pass over image tokens),
  replacing ``flash_attention_pallas``: a Hopper kernel (TMA tile ring,
  ``wgmma``) for bfloat16 at head dims 64, 128 and 256 and at MLA's q·k
  192 with v 128, a Hopper kernel for float32 at the same head dims (TMA
  tile ring, TF32 ``mma.sync``), and a simple kernel for every other
  input it holds; and for training, a differentiable route in bfloat16
  at head dims 64 and 128: the Hopper forward writing each row's
  log-sum-exp and a Hopper backward (``wgmma``) of its own.

CUDA sources live under each kernel's ``csrc/`` and are compiled with
``nvcc`` at first use (:mod:`repro_torch.kernels._build`).
"""

from repro_torch.kernels.am_pack.am_pack import (launch_gather,
                                                 launch_gather_sm90,
                                                 launch_scatter,
                                                 launch_scatter_sm90)
from repro_torch.kernels.attention.flash import (flash_attention_cuda,
                                                 launch_flash_sm90,
                                                 launch_flash_sm90_bwd,
                                                 launch_flash_sm90_f32,
                                                 launch_flash_sm90_lse,
                                                 noncausal_launches)
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
    "flash_attention_sm90": launch_flash_sm90,      # the bf16 Hopper kernel
    "flash_attention_sm90_f32": launch_flash_sm90_f32,  # the float32 one
    "flash_attention_noncausal": noncausal_launches,  # either, causal off
    # the training route: the bf16 Hopper forward with the log-sum-exp,
    # and its backward (one a backward: D, dK / dV, dQ)
    "flash_attention_sm90_lse": launch_flash_sm90_lse,
    "flash_attention_sm90_bwd": launch_flash_sm90_bwd,
}


def launch_counts() -> dict[str, int]:
    """Launches of every kernel so far, by kernel name."""
    return {name: fn.launches for name, fn in LAUNCH_COUNTERS.items()}


def reset_launch_counts() -> None:
    for fn in LAUNCH_COUNTERS.values():
        fn.launches = 0
