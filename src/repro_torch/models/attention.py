"""GQA attention (covers MHA when K == H and MQA when K == 1), the port of
the GQA part of ``repro.models.attention``.

Shape conventions: activations (B, S, d); heads H, kv heads K, head dim
``dh``; ring caches carry absolute slot positions, so a cache of W
slots serves any sequence length.

Two routes compute the same attention:

* the kernel route: when the attention context is exactly the prompt
  (no cache, or a fresh ring cache with S <= W), causal attention by
  index through ``kernels.attention.flash_attention`` -- the hand-written
  CUDA kernel on the card;
* the plain route, :func:`_attend`: masked attention over the ring cache
  by position, exactly as the JAX package computes it (decode, a prompt
  longer than the ring, a cache that already holds entries), and over
  the prompt itself when the caller asks for a ``differentiable`` pass
  (``Model.loss``): the kernels have no backward, and neither has the
  JAX package's flash kernel, whose trainer attends through ``_attend``.

Unlike the JAX package, which returns a new cache, the port writes the
ring cache in place (the returned cache is the one passed in).
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.attention import flash_attention
from repro_torch.models import blocks as bl

NEG = -1e30


# --------------------------------------------------------------------------
# masked softmax attention core
# --------------------------------------------------------------------------

def _attend(q, k, v, q_pos, k_pos):
    """Causal attention by position.  q: (B,S,K,G,dh) k/v: (B,T,K,dh).

    Returns (B,S,K,G,dh).  Slots with k_pos < 0 are invalid (unwritten
    ring-buffer slots).  The JAX package's window and logit cap have no
    caller in the dense family and are not ported.
    """
    dh = q.shape[-1]
    scores = torch.einsum("bskgh,btkh->bkgst", q, k).float()
    scores = scores / math.sqrt(dh)
    k_pos = k_pos[:, None, :]
    mask = (k_pos >= 0) & (k_pos <= q_pos[:, :, None])
    scores = torch.where(mask[:, None, None], scores, NEG)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bkgst,btkh->bskgh", probs, v)


# --------------------------------------------------------------------------
# GQA
# --------------------------------------------------------------------------

def init_gqa(gen, d, H, K, dh, bias: bool = False, lead: tuple = ()):
    """Float32 weights; ``lead`` is a leading shape (the layer axis of a
    stacked segment)."""
    n = len(lead)
    p = {
        "wq": bl.dense_init(gen, lead + (d, H * dh), n),
        "wk": bl.dense_init(gen, lead + (d, K * dh), n),
        "wv": bl.dense_init(gen, lead + (d, K * dh), n),
        "wo": bl.dense_init(gen, lead + (H * dh, d), n),
    }
    if bias:
        for name, width in (("bq", H), ("bk", K), ("bv", K)):
            p[name] = torch.zeros(lead + (width * dh,), device=gen.device)
    return p


def make_kv_cache(B, slots, K, dh, dtype, device, lead: tuple = ()):
    return {
        "k": torch.zeros(lead + (B, slots, K, dh), dtype=dtype, device=device),
        "v": torch.zeros(lead + (B, slots, K, dh), dtype=dtype, device=device),
        "pos": torch.full(lead + (B, slots), -1, dtype=torch.int32,
                          device=device),
    }


def _ring_write(cache, k_new, v_new, positions):
    """Write S new entries at slots pos % W, in place (S <= W guaranteed
    by the caller)."""
    W = cache["k"].shape[1]
    slots = positions.long() % W                          # (B, S)
    _scatter_slots(cache["k"], k_new, slots)
    _scatter_slots(cache["v"], v_new, slots)
    _scatter_slots(cache["pos"], positions.to(cache["pos"].dtype), slots)
    return cache


def _scatter_slots(buf, new, slots):
    # buf (B,W,...), new (B,S,...), slots (B,S); in place
    rows = torch.arange(buf.shape[0], device=buf.device)[:, None]
    buf[rows, slots] = new


def gqa(params, x, positions, *, H, K, dh, rope_base=10000.0, cache=None,
        fresh=False, differentiable=False):
    """Full causal GQA layer: qkv proj -> rope -> attend -> out proj.

    ``positions``: (B, S) absolute positions of x; without a cache they
    are 0..S-1 (the attention context is exactly x).
    ``cache``: None for self-contained (training) attention, else a ring
    cache dict, written in place; returns (out, cache).
    ``fresh``: every slot of ``cache`` is unwritten (pos -1), checked by
    the caller; with S <= W the context is then exactly x as well.
    ``differentiable``: without a cache, attend through :func:`_attend`
    (the JAX package's ``gqa(cache=None)`` route), which autograd can
    differentiate, instead of the forward-only kernel.
    """
    B, S, _ = x.shape
    q = x @ params["wq"].to(x.dtype)
    k = x @ params["wk"].to(x.dtype)
    v = x @ params["wv"].to(x.dtype)
    if "bq" in params:
        q = q + params["bq"].to(x.dtype)
        k = k + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
    q = bl.apply_rope(q.reshape(B, S, H, dh), positions, rope_base)
    k = bl.apply_rope(k.reshape(B, S, K, dh), positions, rope_base)
    v = v.reshape(B, S, K, dh)

    if cache is None and differentiable:
        out = _attend(q.reshape(B, S, K, H // K, dh), k, v, positions,
                      positions)
    elif cache is None:
        out = flash_attention(q, k, v)
    else:
        W = cache["k"].shape[1]
        if S > W:  # prefill longer than the ring: only the last W matter
            kw, vw, pw = k[:, -W:], v[:, -W:], positions[:, -W:]
        else:
            kw, vw, pw = k, v, positions
        kw, vw = kw.to(cache["k"].dtype), vw.to(cache["v"].dtype)
        _ring_write(cache, kw, vw, pw)
        if fresh and S <= W:    # the cache holds exactly this prompt
            out = flash_attention(q, kw.to(q.dtype), vw.to(q.dtype))
        else:
            out = _attend(q.reshape(B, S, K, H // K, dh),
                          cache["k"].to(q.dtype), cache["v"].to(q.dtype),
                          positions, cache["pos"])
    out = out.reshape(B, S, H * dh)
    return out @ params["wo"].to(x.dtype), cache
