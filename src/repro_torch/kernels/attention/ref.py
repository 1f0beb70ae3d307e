"""Plain PyTorch version of the causal flash-attention kernel in
``csrc/flash.cu``: the same function, in the port's GQA layout."""

from __future__ import annotations

import math

import torch

NEG = -1e30                 # the masked score, as in the TPU kernel


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """Causal ``softmax(q kᵀ / sqrt(dh)) v`` by index.

    ``q (B, S, H, dh)``, ``k (B, S, K, dh)``, ``v (B, S, K, dv)`` ->
    ``(B, S, H, dv)``; ``dv`` may differ from ``dh`` (MLA: 192 and 128),
    and the scale stays ``1/sqrt(dh)``, q's head dim.  Query head ``h``
    reads kv head ``h // (H // K)`` (the layout of
    ``q.reshape(B, S, K, H // K, dh)``).  Scores and the softmax are
    float32; the probabilities are rounded to ``v.dtype`` before the
    product with ``v``, as the TPU kernel rounds ``p``."""
    B, S, H, dh = q.shape
    K = k.shape[2]
    qg = q.reshape(B, S, K, H // K, dh).float()
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k.float())
    scores = scores * (1.0 / math.sqrt(dh))
    causal = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    scores = torch.where(causal, scores, NEG)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(B, S, H, v.shape[-1])
