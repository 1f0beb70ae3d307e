from repro_torch.kernels.am_pack.am_pack import (datamover_gather_cuda,
                                                 datamover_kernel_for,
                                                 datamover_plan,
                                                 datamover_scatter_cuda)
from repro_torch.kernels.am_pack.ops import (am_pack, am_unpack,
                                             datamover_gather,
                                             datamover_scatter)
from repro_torch.kernels.am_pack.ref import (am_pack_ref, am_unpack_ref,
                                             datamover_gather_ref,
                                             datamover_scatter_ref)

__all__ = ["am_pack", "am_unpack", "am_pack_ref", "am_unpack_ref",
           "datamover_gather", "datamover_scatter",
           "datamover_gather_ref", "datamover_scatter_ref",
           "datamover_gather_cuda", "datamover_scatter_cuda",
           "datamover_kernel_for", "datamover_plan"]
