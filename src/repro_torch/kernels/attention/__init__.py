from repro_torch.kernels.attention.flash import flash_attention_cuda
from repro_torch.kernels.attention.ops import flash_attention
from repro_torch.kernels.attention.ref import flash_attention_ref

__all__ = ["flash_attention", "flash_attention_ref", "flash_attention_cuda"]
