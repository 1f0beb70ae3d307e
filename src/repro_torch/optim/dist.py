"""Distributed-optimization tricks (the port of ``repro.optim.dist``):
int8 error-feedback gradient compression.  Gradients are quantized per
tensor to int8 before the data-parallel reduction, and the quantization
residual is fed back into the next step's gradients, so the accumulated
error stays bounded.  ``zero1_pspecs`` describes an XLA sharding and is
not ported (ROADMAP)."""

from __future__ import annotations

import torch

from repro_torch.tree import tree_map


def compress_int8(x):
    """x -> (int8 q, float32 scale); symmetric per-tensor quantization,
    rounding half to even (as ``jnp.round``)."""
    xf = x.float()
    scale = torch.clamp(torch.max(torch.abs(xf)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q, scale, dtype=torch.float32):
    return (q.float() * scale).to(dtype)


def make_error_feedback(params):
    """Zero float32 residual buffers, one per gradient leaf."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def ef_compress_tree(grads, residual):
    """(grads + residual) -> (tree of (q, scale) pairs, new residual)."""

    def one(g, r):
        g = g.float() + r
        q, s = compress_int8(g)
        return (q, s), g - decompress_int8(q, s)

    out = tree_map(one, grads, residual)
    pair = lambda x: isinstance(x, tuple)  # noqa: E731
    return (tree_map(lambda o: o[0], out, is_leaf=pair),
            tree_map(lambda o: o[1], out, is_leaf=pair))


def ef_decompress_tree(qtree, dtype=torch.float32):
    return tree_map(lambda qs: decompress_int8(qs[0], qs[1], dtype), qtree,
                    is_leaf=lambda x: isinstance(x, tuple))
