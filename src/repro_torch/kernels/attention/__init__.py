from repro_torch.kernels.attention.flash import (flash_attention_cuda,
                                                 flash_kernel_for,
                                                 launch_flash_sm90,
                                                 launch_flash_sm90_bwd,
                                                 launch_flash_sm90_f32,
                                                 launch_flash_sm90_lse,
                                                 train_kernel_for)
from repro_torch.kernels.attention.ops import (flash_attention,
                                               flash_attention_train)
from repro_torch.kernels.attention.ref import (flash_attention_bwd_ref,
                                               flash_attention_lse_ref,
                                               flash_attention_ref)

__all__ = ["flash_attention", "flash_attention_ref", "flash_attention_cuda",
           "flash_kernel_for", "launch_flash_sm90", "launch_flash_sm90_f32",
           "flash_attention_train", "train_kernel_for",
           "flash_attention_lse_ref", "flash_attention_bwd_ref",
           "launch_flash_sm90_lse", "launch_flash_sm90_bwd"]
