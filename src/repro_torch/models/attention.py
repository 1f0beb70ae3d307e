"""GQA attention (covers MHA when K == H and MQA when K == 1; local,
windowed attention with a ``window``), cross-attention
(llama-3.2-vision's image layers) and DeepSeek-V2's multi-head latent
attention (MLA), the port of the GQA, cross and MLA parts of
``repro.models.attention``.

Shape conventions: activations (B, S, d); heads H, kv heads K, head dim
``dh``; ring caches carry absolute slot positions, so a cache of W
slots serves any sequence length, and sliding-window attention
(recurrentgemma's local layers) keeps a ring of ``window`` slots.

Two routes compute the same attention:

* the kernel route: when the attention context is exactly the prompt
  (no cache, or a fresh ring cache with S <= W) and no key of it is
  beyond a ``window`` (S <= window), causal attention by index through
  ``kernels.attention.flash_attention`` -- the hand-written CUDA kernel
  on the card;
* the plain route, :func:`_attend`: masked attention over the ring cache
  by position, exactly as the JAX package computes it (decode, a prompt
  longer than the ring, a cache that already holds entries, a prompt
  longer than the window: the kernels have no window, nor has the TPU
  kernel), and over the prompt itself when the caller asks for a
  ``differentiable`` pass (``Model.loss``): the kernels have no
  backward, and neither has the JAX package's flash kernel, whose
  trainer attends through ``_attend``.

MLA (:func:`mla`) takes the same two routes for its prompt passes, with
a q·k head dim of ``dh_nope + dh_rope`` and a v head dim of ``dh_v``
(192 and 128 at full width, which the Hopper flash kernel takes in
bfloat16), and a third for a decode step: the absorbed form, whose
scores are taken in the latent space of the cache.

Cross-attention (:func:`cross_attention`) reads its keys and values
from image features, with no causality and no cache: a prompt pass
takes the kernel route (``flash_attention(..., causal=False)``, S text
tokens over the N image tokens), a decode step and a differentiable
pass the plain route.

Unlike the JAX package, which returns a new cache, the port writes the
ring cache in place (the returned cache is the one passed in).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.kernels.attention import flash_attention
from repro_torch.models import blocks as bl

NEG = -1e30


# --------------------------------------------------------------------------
# masked softmax attention core
# --------------------------------------------------------------------------

def _attend(q, k, v, q_pos, k_pos, *, causal=True, window=0,
            logit_cap=0.0):
    """Attention by position.  q: (B,S,K,G,dh) k/v: (B,T,K,dh).

    Returns (B,S,K,G,dh).  In the JAX package's order: the scores scaled
    by 1/sqrt(dh), capped to ``logit_cap * tanh(s / logit_cap)`` where
    ``logit_cap`` is set (no model of the JAX package sets it), then
    masked to -1e30: slots with k_pos < 0 (unwritten ring-buffer slots),
    with ``causal`` the slots past each query's position, with
    ``window`` the slots ``window`` or more positions before it.  A row
    with every slot masked gives the uniform average of the values, as
    in the JAX package (the fill is finite).
    """
    dh = q.shape[-1]
    scores = torch.einsum("bskgh,btkh->bkgst", q, k).float()
    scores = scores / math.sqrt(dh)
    if logit_cap:
        scores = logit_cap * torch.tanh(scores / logit_cap)
    k_pos = k_pos[:, None, :]
    q_pos = q_pos[:, :, None]
    mask = k_pos >= 0
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window:
        mask = mask & (k_pos > q_pos - window)
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


_scatter2 = _scatter_slots     # the JAX package's name for the MLA caches


def gqa(params, x, positions, *, H, K, dh, window=0, rope_base=10000.0,
        cache=None, fresh=False, differentiable=False):
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
    ``window``: sliding-window (local) attention, each query over the
    ``window`` positions up to its own; 0 for none.  A prompt of S <=
    window tokens over itself sees no key the window masks, so it takes
    the kernel route; a longer one without a cache, and a ring of
    ``window`` slots that holds more than this prompt, take
    :func:`_attend` with the window.  A prompt longer than the ring
    keeps only its last W keys there and attends every query to them,
    as the JAX package does (ROADMAP §3, reference caveats).
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

    if cache is None and (differentiable or window and S > window):
        out = _attend(q.reshape(B, S, K, H // K, dh), k, v, positions,
                      positions, window=window)
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
        # the cache holds exactly this prompt, and the window masks none
        # of it (a local layer's ring has W <= window slots)
        if fresh and S <= W and (not window or S <= window):
            out = flash_attention(q, kw.to(q.dtype), vw.to(q.dtype))
        else:
            out = _attend(q.reshape(B, S, K, H // K, dh),
                          cache["k"].to(q.dtype), cache["v"].to(q.dtype),
                          positions, cache["pos"], window=window)
    out = out.reshape(B, S, H * dh)
    return out @ params["wo"].to(x.dtype), cache


# --------------------------------------------------------------------------
# cross-attention (llama-3.2-vision image layers)
# --------------------------------------------------------------------------

def init_cross(gen, d, H, K, dh, lead: tuple = ()):
    """Float32 projections, the q / k norms' scales (ones) and the tanh
    gate (zero: the layer starts closed); ``lead`` as in
    :func:`init_gqa`."""
    n = len(lead)
    ones = torch.ones(lead + (dh,), device=gen.device)
    return {
        "wq": bl.dense_init(gen, lead + (d, H * dh), n),
        "wk": bl.dense_init(gen, lead + (d, K * dh), n),
        "wv": bl.dense_init(gen, lead + (d, K * dh), n),
        "wo": bl.dense_init(gen, lead + (H * dh, d), n),
        "gate": torch.zeros(lead, device=gen.device),
        "kln": ones,
        "qln": ones.clone(),
    }


def cross_attention(params, x, kv_feats, *, H, K, dh, differentiable=False):
    """Cross-attention, as the JAX package's ``cross_attention``: q from
    the text stream ``x (B, S, d)``, k and v from image features
    ``kv_feats (B, N, d)`` (cast to ``x.dtype`` before the projections),
    q and k RMS-normed over the head dim, no rope, every one of the N
    image tokens visible, the output projection, then ``tanh(gate)``
    cast to ``x.dtype`` as a factor.  A prompt pass (S > 1) takes the
    kernel route, ``flash_attention(..., causal=False)``; a decode step
    (S == 1) and a ``differentiable`` pass the plain route,
    :func:`_attend`."""
    B, S, _ = x.shape
    N = kv_feats.shape[1]
    feats = kv_feats.to(x.dtype)
    q = (x @ params["wq"].to(x.dtype)).reshape(B, S, K, H // K, dh)
    k = (feats @ params["wk"].to(x.dtype)).reshape(B, N, K, dh)
    v = (feats @ params["wv"].to(x.dtype)).reshape(B, N, K, dh)
    q = bl.rms_norm(q, params["qln"])
    k = bl.rms_norm(k, params["kln"])
    if S > 1 and not differentiable:
        out = flash_attention(q.reshape(B, S, H, dh), k, v, causal=False)
    else:
        zeros = torch.zeros((), dtype=torch.int32, device=x.device)
        out = _attend(q, k, v, zeros.expand(B, S), zeros.expand(B, N),
                      causal=False)
    out = out.reshape(B, S, H * dh) @ params["wo"].to(x.dtype)
    return torch.tanh(params["gate"]).to(x.dtype) * out


# --------------------------------------------------------------------------
# DeepSeek-V2 MLA
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MLADims:
    q_lora: int = 1536
    kv_lora: int = 512
    dh_nope: int = 128
    dh_rope: int = 64
    dh_v: int = 128


def init_mla(gen, d, H, dims: MLADims, lead: tuple = ()):
    """Float32 weights and the two latent norms' scales (ones); ``lead``
    as in :func:`init_gqa`."""
    n = len(lead)

    def dense(shape):
        return bl.dense_init(gen, lead + shape, n)

    def ones(width):
        return torch.ones(lead + (width,), device=gen.device)

    return {
        "wdq": dense((d, dims.q_lora)),
        "qln": ones(dims.q_lora),
        "wuq": dense((dims.q_lora, H * (dims.dh_nope + dims.dh_rope))),
        "wdkv": dense((d, dims.kv_lora)),
        "kvln": ones(dims.kv_lora),
        "wkr": dense((d, dims.dh_rope)),
        "wuk": dense((dims.kv_lora, H * dims.dh_nope)),
        "wuv": dense((dims.kv_lora, H * dims.dh_v)),
        "wo": dense((H * dims.dh_v, d)),
    }


def make_mla_cache(B, slots, dims: MLADims, dtype, device, lead: tuple = ()):
    """MLA caches the *latent* c_kv and the shared rope key: kv_lora +
    dh_rope words a token (576 at full width) against GQA's 2 K dh."""
    return {
        "ckv": torch.zeros(lead + (B, slots, dims.kv_lora), dtype=dtype,
                           device=device),
        "kr": torch.zeros(lead + (B, slots, dims.dh_rope), dtype=dtype,
                          device=device),
        "pos": torch.full(lead + (B, slots), -1, dtype=torch.int32,
                          device=device),
    }


def _mla_qkr(params, x, positions, H, dims):
    """Per-head q (nope and roped halves), the latent c_kv and the shared
    roped key ``kr (B, S, dh_rope)``.  Rope takes the default base, as in
    the JAX package, whatever the model's ``rope_base``."""
    B, S, _ = x.shape
    cq = bl.rms_norm(x @ params["wdq"].to(x.dtype), params["qln"])
    q = (cq @ params["wuq"].to(x.dtype)).reshape(
        B, S, H, dims.dh_nope + dims.dh_rope)
    q_nope, q_rope = q[..., :dims.dh_nope], q[..., dims.dh_nope:]
    q_rope = bl.apply_rope(q_rope, positions)
    kr = bl.apply_rope((x @ params["wkr"].to(x.dtype))[:, :, None, :],
                       positions)[:, :, 0]
    ckv = bl.rms_norm(x @ params["wdkv"].to(x.dtype), params["kvln"])
    return q_nope, q_rope, ckv, kr


def _mla_heads(params, ckv, kr, H, dims):
    """The materialized per-head keys ``(B, T, H, dh_nope + dh_rope)``
    (the shared rope key broadcast to every head) and values ``(B, T, H,
    dh_v)`` of latents ``ckv (B, T, kv_lora)``."""
    B, T, _ = ckv.shape
    k_nope = (ckv @ params["wuk"].to(ckv.dtype)).reshape(B, T, H,
                                                          dims.dh_nope)
    v = (ckv @ params["wuv"].to(ckv.dtype)).reshape(B, T, H, dims.dh_v)
    k = torch.cat([k_nope, kr[:, :, None].expand(B, T, H, dims.dh_rope)], -1)
    return k, v


def _mla_absorbed(params, q_nope, q_rope, ckv, kr, positions, k_pos, H,
                  dims):
    """Attention of one decode step in latent space (the DeepSeek-V2
    inference trick): ``q_c = q_nope W_uk^T`` per head, scores against
    the cached latents and rope keys, ``o_c = probs ckv`` lifted by
    ``W_uv``.  The JAX package's operations, in its order and types."""
    C = dims.kv_lora
    dt = q_nope.dtype
    wuk = params["wuk"].to(dt).reshape(C, H, dims.dh_nope)
    q_c = torch.einsum("bshn,chn->bshc", q_nope, wuk)
    s_c = torch.einsum("bshc,btc->bhst", q_c, ckv)
    s_r = torch.einsum("bshn,btn->bhst", q_rope, kr)
    scores = (s_c + s_r).float() / math.sqrt(dims.dh_nope + dims.dh_rope)
    k_pos = k_pos[:, None, :]
    mask = (k_pos >= 0) & (k_pos <= positions[:, :, None])
    scores = torch.where(mask[:, None], scores, NEG)
    probs = torch.softmax(scores, dim=-1).to(dt)
    o_c = torch.einsum("bhst,btc->bshc", probs, ckv)      # latent output
    wuv = params["wuv"].to(dt).reshape(C, H, dims.dh_v)
    return torch.einsum("bshc,chv->bshv", o_c, wuv)


def _mla_materialized(params, q_nope, q_rope, ckv, kr, positions, k_pos, H,
                      dims):
    """Attention over latents ``ckv (B, T, kv_lora)`` in the materialized
    form: per-head keys and values (:func:`_mla_heads`), masked by
    position through :func:`_attend`, as the JAX package computes every
    prompt pass.  Takes :func:`_mla_absorbed`'s arguments and gives its
    function: ``chip_smoke.py`` puts it in the absorbed form's place to
    check that identity on the card."""
    k, v = _mla_heads(params, ckv, kr, H, dims)
    q = torch.cat([q_nope, q_rope], -1)[:, :, :, None, :]
    return _attend(q, k, v, positions, k_pos)


def mla(params, x, positions, *, H, dims: MLADims, cache=None, fresh=False,
        differentiable=False):
    """Full MLA layer: latent projections -> rope -> attend -> out proj.

    ``positions``, ``cache``, ``fresh`` and ``differentiable`` as in
    :func:`gqa`.  Three routes:

    * the kernel route (no cache and not ``differentiable``, or a fresh
      cache with S <= W): per-head keys and values from the prompt's own
      latents, causal attention by index through ``flash_attention`` at
      q·k dim ``dh_nope + dh_rope`` and v dim ``dh_v``;
    * the plain route (a cache that holds entries, a prompt longer than
      the ring, ``differentiable``): :func:`_mla_materialized` over the
      whole ring, as the JAX package computes every prompt pass;
    * the absorbed route (one token with a cache that is not fresh): the
      JAX package's decode form, :func:`_mla_absorbed`.
    """
    B, S, _ = x.shape
    q_nope, q_rope, ckv, kr = _mla_qkr(params, x, positions, H, dims)
    if cache is not None:
        W = cache["ckv"].shape[1]
        if S > W:  # prefill longer than the ring: only the last W matter
            ckv_w, kr_w, pw = ckv[:, -W:], kr[:, -W:], positions[:, -W:]
        else:
            ckv_w, kr_w, pw = ckv, kr, positions
        ckv_w = ckv_w.to(cache["ckv"].dtype)
        kr_w = kr_w.to(cache["kr"].dtype)
        slots = pw.long() % W
        _scatter2(cache["ckv"], ckv_w, slots)
        _scatter2(cache["kr"], kr_w, slots)
        _scatter2(cache["pos"], pw.to(cache["pos"].dtype), slots)

    if cache is None:
        ckv_c, kr_c, k_pos = ckv, kr, positions
        kernel = not differentiable
    elif fresh and S <= W:      # the cache holds exactly this prompt
        ckv_c, kr_c, k_pos = ckv_w.to(x.dtype), kr_w.to(x.dtype), pw
        kernel = True
    else:
        ckv_c, kr_c = cache["ckv"].to(x.dtype), cache["kr"].to(x.dtype)
        k_pos, kernel = cache["pos"], False
    if kernel:
        k, v = _mla_heads(params, ckv_c, kr_c, H, dims)
        out = flash_attention(torch.cat([q_nope, q_rope], -1), k, v)
    elif cache is not None and S == 1:
        out = _mla_absorbed(params, q_nope, q_rope, ckv_c, kr_c, positions,
                            k_pos, H, dims)
    else:
        out = _mla_materialized(params, q_nope, q_rope, ckv_c, kr_c,
                                positions, k_pos, H, dims)
    out = out.reshape(B, S, H * dims.dh_v)
    return out @ params["wo"].to(x.dtype), cache
