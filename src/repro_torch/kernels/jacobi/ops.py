"""Jacobi wrappers: the CUDA kernel for CUDA tensors, the plain version
for CPU tensors, and nothing else (no fallback)."""

from __future__ import annotations

import torch

from repro_torch.kernels.jacobi.jacobi import jacobi_sweep_cuda
from repro_torch.kernels.jacobi.ref import jacobi_band_ref, jacobi_step_ref


def jacobi_step(x: torch.Tensor) -> torch.Tensor:
    """One iteration over a full ``(M, N)`` grid; returns a new grid."""
    if x.device.type == "cpu":
        return jacobi_step_ref(x)
    x3 = x.contiguous()[None]
    return jacobi_sweep_cuda(x3, torch.empty_like(x3), in_row0=0)[0]


def jacobi_band_step(x_pad: torch.Tensor,
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """One iteration over ``K`` row bands with halo rows attached:
    ``x_pad (K, rows+2, N) -> (K, rows, N)``, all bands in one launch.
    ``out`` (optional) receives the result, e.g. ``buf[:, 1:-1]`` of a
    second padded buffer, so an iteration loop swaps two buffers."""
    K, rows2, n = x_pad.shape
    if out is None:
        out = torch.empty((K, rows2 - 2, n), dtype=x_pad.dtype,
                          device=x_pad.device)
    if x_pad.device.type == "cpu":
        out.copy_(jacobi_band_ref(x_pad))
        return out
    return jacobi_sweep_cuda(x_pad, out, in_row0=1)


def jacobi_run(x: torch.Tensor, iters: int) -> torch.Tensor:
    """``iters`` full-grid iterations."""
    for _ in range(iters):
        x = jacobi_step(x)
    return x
