"""Shared neural blocks: norms, MLPs, rotary embeddings, initializers
(the port of ``repro.models.blocks``)."""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

# --------------------------------------------------------------------------
# initializers: float32 normals from an explicit generator, on its device.
# Only the scale matters; parity tests carry the JAX package's weights
# across instead (models/convert.py).
# --------------------------------------------------------------------------


def dense_init(gen: torch.Generator, shape, in_axis: int = 0):
    fan_in = shape[in_axis] if shape else 1
    scale = 1.0 / np.sqrt(max(fan_in, 1))
    return torch.randn(shape, generator=gen, device=gen.device) * scale


def embed_init(gen: torch.Generator, shape):
    return torch.randn(shape, generator=gen, device=gen.device) * 0.02


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------

def rms_norm(x, scale, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * scale.float()
    return out.to(dt)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    out = (x - mu) * torch.rsqrt(var + eps)
    out = out * scale.float() + bias.float()
    return out.to(dt)


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------

def swiglu(x, wg, wu, wd):
    """SwiGLU gated MLP (llama/qwen/deepseek family)."""
    g = F.silu(x @ wg.to(x.dtype))
    u = x @ wu.to(x.dtype)
    return (g * u) @ wd.to(x.dtype)


def gelu_mlp(x, wi, bi, wo, bo):
    """Plain GELU MLP (musicgen family); tanh-approximate, as
    ``jax.nn.gelu`` is by default."""
    h = F.gelu(x @ wi.to(x.dtype) + bi.to(x.dtype), approximate="tanh")
    return h @ wo.to(x.dtype) + bo.to(x.dtype)


# --------------------------------------------------------------------------
# rotary position embeddings
# --------------------------------------------------------------------------

def rope_freqs(dh: int, base: float = 10000.0):
    return 1.0 / (base ** (np.arange(0, dh, 2, dtype=np.float32) / dh))


@functools.lru_cache(maxsize=None)
def _freqs_on(dh: int, base: float, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(rope_freqs(dh, base)).to(device)


def apply_rope(x, positions, base: float = 10000.0):
    """x: (..., S, H, dh); positions: broadcastable to (..., S).  Half
    split (not interleaved), angles in float32."""
    dh = x.shape[-1]
    freqs = _freqs_on(dh, float(base), x.device)
    angles = positions[..., None].float() * freqs          # (..., S, dh/2)
    angles = angles[..., None, :]                          # (..., S, 1, dh/2)
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------

def softmax_xent(logits, labels, mask=None, z_loss: float = 0.0):
    """Mean next-token cross-entropy, in float32 (``logsumexp`` too).
    ``mask`` is 1 for counted positions."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    loss = lse - ll
    if z_loss:
        loss = loss + z_loss * torch.square(lse)
    if mask is None:
        return torch.mean(loss)
    mask = mask.float()
    return torch.sum(loss * mask) / torch.clamp(torch.sum(mask), min=1.0)
