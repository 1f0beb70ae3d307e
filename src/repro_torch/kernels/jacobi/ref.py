"""Plain PyTorch versions of the Jacobi stencil (paper Sec. IV-C), in the
two forms the CUDA kernel ``csrc/jacobi.cu`` takes."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def jacobi_step_ref(x: torch.Tensor) -> torch.Tensor:
    """One Jacobi iteration over a full ``(M, N)`` grid: interior cells
    become the mean of their four von Neumann neighbors; boundary cells
    are fixed (Dirichlet)."""
    out = x.clone()
    up, down = x[:-2, 1:-1], x[2:, 1:-1]
    left, right = x[1:-1, :-2], x[1:-1, 2:]
    out[1:-1, 1:-1] = 0.25 * (up + down + left + right)
    return out


def jacobi_band_ref(x_pad: torch.Tensor) -> torch.Tensor:
    """One iteration over ``K`` row bands with their halo rows attached:
    ``x_pad (K, rows+2, N) -> (K, rows, N)``.  Band ``k`` holds global
    rows ``k*rows .. k*rows+rows-1`` of a ``K*rows``-row grid; the global
    first/last row and the first/last column stay fixed."""
    K, rows2, n = x_pad.shape
    rows = rows2 - 2
    up, down, mid = x_pad[:, :-2], x_pad[:, 2:], x_pad[:, 1:-1]
    left = F.pad(mid[..., :-1], (1, 0))
    right = F.pad(mid[..., 1:], (0, 1))
    stencil = 0.25 * (up + down + left + right)
    dev = x_pad.device
    grow = (torch.arange(K, device=dev)[:, None, None] * rows
            + torch.arange(rows, device=dev)[None, :, None])
    gcol = torch.arange(n, device=dev)
    interior = ((grow > 0) & (grow < K * rows - 1)
                & (gcol > 0) & (gcol < n - 1))
    return torch.where(interior, stencil, mid)
