"""Flash-attention wrappers: a CUDA kernel for CUDA tensors (a Hopper
kernel -- bfloat16 or float32 -- or the simple one, chosen by shape
before the launch), the plain
version for CPU tensors, and nothing else (no fallback).

:func:`flash_attention` is forward-only.  :func:`flash_attention_train`
is the differentiable causal route for training: one operator,
``repro_torch::flash_attention_train`` (``torch.library.custom_op``),
whose backward is a second one, ``repro_torch::flash_attention_train_bwd``.
On CUDA tensors they run the training route's Hopper kernels
(``flash.flash_attention_lse_cuda``, ``flash.flash_attention_bwd_cuda``)
on what ``flash.train_kernel_for`` sends there, and raise on anything
else; on CPU tensors the blockwise plain versions
(``ref.flash_attention_lse_ref``, ``ref.flash_attention_bwd_ref``).  An
operator and not a chain of tensor operations: the ``dots`` policy's
dispatch mode sees one call, recomputes it (it is not ``aten.mm``) and
runs nothing inside it through Python."""

from __future__ import annotations

import torch

from repro_torch.kernels.attention import flash as fl
from repro_torch.kernels.attention.flash import flash_attention_cuda
from repro_torch.kernels.attention.ref import (flash_attention_bwd_ref,
                                               flash_attention_lse_ref,
                                               flash_attention_ref)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Attention by index with ``sm_scale = 1/sqrt(dh)``: ``q (B, S, H,
    dh)``, ``k (B, T, K, dh)``, ``v (B, T, K, dv)`` -> ``(B, S, H, dv)``.
    ``causal``: a prompt over itself (``T == S``, query s reads keys
    t <= s); without it, ``S`` queries over all ``T >= 1`` keys
    (cross-attention's prompt pass over the image tokens).  ``dv`` is
    ``dh`` or, for MLA's prompt passes, ``(dh, dv) = (192, 128)`` (the
    Hopper kernels on the card, in bfloat16 and in float32).  The
    counterpart of the JAX package's
    ``kernels.attention.flash_attention`` (there ``(BH, S, dh)`` padded
    to a block multiple, ``T == S``; here the heads stay in place, kv
    heads are shared by ``H // K`` query heads without a copy, and the
    kernel masks its last block instead of padding).

    Forward only, as the JAX package's kernel is: with grad mode on and
    an input that requires grad this raises, on every device, since the
    CUDA kernel's output has no autograd edge and would cut the
    gradient silently.  A differentiable pass attends through
    ``Model.loss``'s route (``models.attention.gqa(differentiable=
    True)``): :func:`flash_attention_train` where the training route's
    kernels take the inputs, else ``models.attention._attend``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention is forward-only (the kernel has no backward) "
            "and got inputs that require grad; differentiate through "
            "Model.loss, which attends via models.attention._attend "
            "(gqa(differentiable=True))")
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal)
    return flash_attention_cuda(q, k, v, causal=causal)


@torch.library.custom_op("repro_torch::flash_attention_train",
                         mutates_args=(),
                         schema="(Tensor q, Tensor k, Tensor v) -> "
                                "(Tensor, Tensor)")
def _train_fwd(q, k, v):
    if q.device.type == "cpu":
        return flash_attention_lse_ref(q, k, v)
    return fl.flash_attention_lse_cuda(q, k, v)


@_train_fwd.register_fake
def _(q, k, v):
    B, S, H, _ = q.shape
    return (q.new_empty(q.shape[:-1] + v.shape[-1:]),
            q.new_empty((B, H, S), dtype=torch.float32))


@torch.library.custom_op("repro_torch::flash_attention_train_bwd",
                         mutates_args=(),
                         schema="(Tensor q, Tensor k, Tensor v, Tensor out, "
                                "Tensor lse, Tensor dout) -> "
                                "(Tensor, Tensor, Tensor)")
def _train_bwd(q, k, v, out, lse, dout):
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, out, lse, dout)
    return fl.flash_attention_bwd_cuda(q, k, v, out, lse, dout)


@_train_bwd.register_fake
def _(q, k, v, out, lse, dout):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs, *output)
    ctx.mark_non_differentiable(output[1])


def _backward(ctx, dout, _dlse):
    q, k, v, out, lse = ctx.saved_tensors
    return _train_bwd(q, k, v, out, lse, dout)


_train_fwd.register_autograd(_backward, setup_context=_setup)


def flash_attention_train(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """Causal attention by index that autograd differentiates: ``q (B,
    S, H, dh)``, ``k`` and ``v (B, S, K, dh)`` -> ``(B, S, H, dh)``, the
    function of :func:`flash_attention`.  On the card it takes what
    ``flash.train_kernel_for`` sends to ``"sm90"`` (the caller decides,
    ``models.attention.gqa``) and raises on the rest; on the CPU it runs
    the plain versions (tests)."""
    return _train_fwd(q, k, v)[0]
