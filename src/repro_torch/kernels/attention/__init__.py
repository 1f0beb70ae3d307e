from repro_torch.kernels.attention.flash import (flash_attention_cuda,
                                                 flash_kernel_for,
                                                 launch_flash_sm90)
from repro_torch.kernels.attention.ops import flash_attention
from repro_torch.kernels.attention.ref import flash_attention_ref

__all__ = ["flash_attention", "flash_attention_ref", "flash_attention_cuda",
           "flash_kernel_for", "launch_flash_sm90"]
