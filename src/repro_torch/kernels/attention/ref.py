"""Plain PyTorch version of the flash-attention kernels in ``csrc/``: the
same function, in the port's GQA layout."""

from __future__ import annotations

import math

import torch

NEG = -1e30                 # the masked score, as in the TPU kernel


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor, *, causal: bool = True,
                        scale: float | None = None) -> torch.Tensor:
    """``softmax(q kᵀ / sqrt(dh)) v`` by index, causal or over every key.

    ``q (B, S, H, dh)``, ``k (B, T, K, dh)``, ``v (B, T, K, dv)`` ->
    ``(B, S, H, dv)``; ``dv`` may differ from ``dh`` (MLA: 192 and 128),
    and the scale stays ``1/sqrt(dh)``, q's head dim, unless ``scale``
    gives another (a head dim zero-padded to a kernel's tile keeps the
    true one's).  With ``causal`` query s reads keys t <= s only, and
    ``T == S``; without it every one of the ``T >= 1`` keys is valid
    (cross-attention over image tokens).  Query head ``h`` reads kv head
    ``h // (H // K)`` (the layout of ``q.reshape(B, S, K, H // K, dh)``).
    Scores and the softmax are float32; the probabilities are rounded to
    ``v.dtype`` before the product with ``v``, as the TPU kernel rounds
    ``p``."""
    B, S, H, dh = q.shape
    K, T = k.shape[2], k.shape[1]
    if causal and T != S:
        raise ValueError(f"causal attention takes k and v of q's length "
                         f"{S}, got {T}")
    qg = q.reshape(B, S, K, H // K, dh).float()
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k.float())
    scores = scores * (1.0 / math.sqrt(dh) if scale is None else scale)
    if causal:
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        scores = torch.where(mask, scores, NEG)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(B, S, H, v.shape[-1])


def flash_attention_lse_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor):
    """Causal :func:`flash_attention_ref` and the float32 log-sum-exp of
    each query row's scaled scores, ``lse (B, H, S)``: what the training
    route's forward returns (``flash_attention_sm90_fwd_lse``)."""
    B, S, H, dh = q.shape
    K = k.shape[2]
    if k.shape[1] != S:
        raise ValueError(f"causal attention takes k and v of q's length "
                         f"{S}, got {k.shape[1]}")
    qg = q.reshape(B, S, K, H // K, dh).float()
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) / math.sqrt(dh)
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    scores = torch.where(mask, scores, NEG)
    lse = torch.logsumexp(scores, dim=-1).reshape(B, H, S)
    probs = torch.exp(scores - lse.reshape(B, K, H // K, S, 1)).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(B, S, H, v.shape[-1]), lse


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, out: torch.Tensor,
                            lse: torch.Tensor, dout: torch.Tensor, *,
                            block: int = 64):
    """The gradients ``(dq, dk, dv)`` of causal attention at ``dout``,
    blockwise as ``csrc/flash_sm90_bwd.cu`` computes them: q ``(B, S, H,
    dh)``, k and v ``(B, S, K, dh)``, ``out`` the forward's output and
    ``lse (B, H, S)`` its log-sum-exp.  For each key block of ``block``
    keys, with ``c = 1/sqrt(dh)``: ``P = exp(c q kᵀ - lse)`` (0 past the
    diagonal), ``dP = dO vᵀ``, ``D = rowsum(dO ∘ out)``, ``dS = P ∘ (dP -
    D)``, all float32; ``dV = Pᵀ dO``, ``dK = c dSᵀ q`` summed over the
    ``G = H / K`` query heads of a kv head, ``dQ += c dS k``, with P and
    dS rounded to ``q.dtype`` as the products' operands and the sums
    float32, rounded once at the end."""
    B, S, H, dh = q.shape
    K = k.shape[2]
    G = H // K
    c = 1.0 / math.sqrt(dh)
    dt = q.dtype
    qg = q.reshape(B, S, K, G, dh).float()
    dog = dout.reshape(B, S, K, G, dh).float()
    dsum = (dout.float() * out.float()).sum(-1).reshape(B, S, K, G)
    dsum = dsum.permute(0, 2, 3, 1)[..., None]             # (B, K, G, S, 1)
    lse = lse.reshape(B, K, G, S, 1)
    rows = torch.arange(S, device=q.device)[:, None]
    dq = torch.zeros(B, S, K, G, dh, device=q.device)
    dk = torch.zeros(B, S, K, dh, device=q.device)
    dv = torch.zeros(B, S, K, v.shape[-1], device=q.device)
    for n0 in range(0, S, block):
        kb = k[:, n0:n0 + block].float()
        vb = v[:, n0:n0 + block].float()
        keys = torch.arange(n0, n0 + kb.shape[1], device=q.device)[None]
        s = torch.einsum("bskgd,btkd->bkgst", qg, kb) * c
        p = torch.where(keys <= rows, torch.exp(s - lse), 0.0)
        dp = torch.einsum("bskgd,btkd->bkgst", dog, vb)
        ds = p * (dp - dsum)
        pr, dsr = p.to(dt).float(), ds.to(dt).float()
        dv[:, n0:n0 + block] = torch.einsum("bkgst,bskgd->btkd", pr, dog)
        dk[:, n0:n0 + block] = c * torch.einsum("bkgst,bskgd->btkd", dsr, qg)
        dq += c * torch.einsum("bkgst,btkd->bskgd", dsr, kb)
    return (dq.reshape(B, S, H, dh).to(dt), dk.to(k.dtype),
            dv.to(v.dtype))
