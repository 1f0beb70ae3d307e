"""Flash-attention wrapper: a CUDA kernel for CUDA tensors (the Hopper
kernel or the simple one, chosen by shape before the launch), the plain
version for CPU tensors, and nothing else (no fallback)."""

from __future__ import annotations

import torch

from repro_torch.kernels.attention.flash import flash_attention_cuda
from repro_torch.kernels.attention.ref import flash_attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Attention by index with ``sm_scale = 1/sqrt(dh)``: ``q (B, S, H,
    dh)``, ``k (B, T, K, dh)``, ``v (B, T, K, dv)`` -> ``(B, S, H, dv)``.
    ``causal``: a prompt over itself (``T == S``, query s reads keys
    t <= s); without it, ``S`` queries over all ``T >= 1`` keys
    (cross-attention's prompt pass over the image tokens).  ``dv`` is
    ``dh`` or, for MLA's prompt passes, ``(dh, dv) = (192, 128)`` (the
    Hopper kernel on the card in bfloat16, the simple one in float32).  The counterpart of the JAX package's
    ``kernels.attention.flash_attention`` (there ``(BH, S, dh)`` padded
    to a block multiple, ``T == S``; here the heads stay in place, kv
    heads are shared by ``H // K`` query heads without a copy, and the
    kernel masks its last block instead of padding).

    Forward only, as the JAX package's kernel is: with grad mode on and
    an input that requires grad this raises, on every device, since the
    CUDA kernel's output has no autograd edge and would cut the
    gradient silently.  A differentiable pass attends through
    ``Model.loss``'s route, ``models.attention._attend``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention is forward-only (the kernel has no backward) "
            "and got inputs that require grad; differentiate through "
            "Model.loss, which attends via models.attention._attend "
            "(gqa(differentiable=True))")
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal)
    return flash_attention_cuda(q, k, v, causal=causal)
