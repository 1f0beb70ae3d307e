"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427), the
port of ``repro.models.recurrent``.

The temporal-mixing block is: RMSNorm -> two branches
  gate branch:      linear (d -> dr) -> GeLU
  recurrent branch: linear (d -> dr) -> causal conv1d(width 4) -> RG-LRU
-> elementwise product -> output linear (dr -> d).

RG-LRU recurrence (per channel):
  r_t = sigmoid(W_r x_t),  i_t = sigmoid(W_i x_t)
  a_t = exp(-c * softplus(L) * r_t)           (c = 8)
  h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

A prompt or training pass evaluates the linear recurrence with a
log-depth scan (:func:`_lru_scan`: the odd / even recursion of
``jax.lax.associative_scan``, so the float32 products and sums are the
JAX package's, in its order; about 2 log2(S) rounds of a few operations
where a loop would take 3 S); a decode step carries ``h`` as O(dr) state
per layer.  The state (``h`` and the convolution's trailing ``conv``
inputs) is float32 whatever the model's dtype, and :func:`rglru_block`
writes it in place, as the port writes its ring caches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import blocks as bl

_C = 8.0


def init_rglru(gen, d, dr, nb: int, conv_width: int = 4, lead: tuple = ()):
    """Float32 weights; ``nb`` gate blocks (block-diagonal gate
    projections, as in the reference RecurrentGemma implementation);
    ``lead`` is a leading shape (the layer axis of a stacked segment).
    ``lam`` is drawn so ``a = exp(-c softplus(lam))`` starts in 0.9 ..
    0.999: ``lam = log(expm1(-log(u) / c))``, ``u ~ U(0.9, 0.999)``."""
    n = len(lead)
    drb = dr // nb
    u = torch.rand(lead + (dr,), generator=gen, device=gen.device)
    u = u * (0.999 - 0.9) + 0.9
    lam = torch.log(torch.expm1(-torch.log(u) / _C))
    return {
        "wx": bl.dense_init(gen, lead + (d, dr), n),      # recurrent in
        "wy": bl.dense_init(gen, lead + (d, dr), n),      # gate branch in
        "conv": bl.dense_init(gen, lead + (conv_width, dr), n).mul_(0.1),
        "wr": bl.dense_init(gen, lead + (nb, drb, drb), n + 1),   # gates
        "wi": bl.dense_init(gen, lead + (nb, drb, drb), n + 1),
        "lam": lam,
        "wo": bl.dense_init(gen, lead + (dr, d), n),
    }


def _block_diag(x, w):
    """x: (B,S,dr) @ block-diagonal w: (nb,drb,drb) -> (B,S,dr)."""
    B, S, dr = x.shape
    nb, drb, _ = w.shape
    xb = x.reshape(B, S, nb, drb)
    return torch.einsum("bsnd,nde->bsne", xb, w.to(x.dtype)).reshape(B, S,
                                                                     dr)


def _conv1d_causal(x, w, state=None):
    """Causal depthwise conv along S. x: (B,S,dr), w: (W,dr).

    ``state``: (B, W-1, dr) trailing context of a decode or a chunked
    prefill, or None (zeros).  Returns (out, new_state), both in
    ``x.dtype``; the W terms are summed in ``x.dtype`` in the JAX
    package's order."""
    W, S = w.shape[0], x.shape[1]
    if state is None:
        pad = x.new_zeros((x.shape[0], W - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    out = xp[:, 0:S] * w[0].to(x.dtype)
    for i in range(1, W):
        out = out + xp[:, i:i + S] * w[i].to(x.dtype)
    return out, xp[:, -(W - 1):]


def _combine(left, right):
    """The affine maps' composition: (a_l, b_l) then (a_r, b_r)."""
    al, bl_ = left
    ar, br = right
    return al * ar, br + ar * bl_


def _take(x, dim: int, start, stop=None, step=None):
    """``x[start:stop:step]`` along ``dim`` (a view)."""
    return x[(slice(None),) * dim + (slice(start, stop, step),)]


def _interleave(even, odd, dim: int):
    """``even[0], odd[0], even[1], ...`` along ``dim`` (``even`` as long
    as ``odd`` or one longer)."""
    shape = list(even.shape)
    shape[dim] += odd.shape[dim]
    out = even.new_empty(shape)
    _take(out, dim, 0, None, 2).copy_(even)
    _take(out, dim, 1, None, 2).copy_(odd)
    return out


def associative_scan(fn, elems, dim: int = 0):
    """Inclusive scan of the tuple of tensors ``elems`` along ``dim`` by
    ``jax.lax.associative_scan``'s recursion, so ``fn`` (an associative
    ``(left, right) -> combined`` over tuples) runs on the same pairs in
    the same order: combine adjacent pairs, scan the pairs, then fill in
    the even positions.  The RG-LRU's affine pairs (:func:`_lru_scan`)
    and the mLSTM's chunk memories (``xlstm._chunk_mlstm``) both go
    through it."""
    elems = tuple(elems)
    n = elems[0].shape[dim]
    if n < 2:
        return elems
    reduced = fn(tuple(_take(e, dim, 0, -1, 2) for e in elems),
                 tuple(_take(e, dim, 1, None, 2) for e in elems))
    odd = associative_scan(fn, reduced, dim)
    rest = tuple(_take(e, dim, 2, None, 2) for e in elems)
    if n % 2 == 0:
        even = fn(tuple(_take(o, dim, 0, -1) for o in odd), rest)
    else:
        even = fn(odd, rest)
    even = tuple(torch.cat([_take(e, dim, 0, 1), r], dim=dim)
                 for e, r in zip(elems, even))
    return tuple(_interleave(e, o, dim) for e, o in zip(even, odd))


def _lru_scan(a, bx):
    """h_t = a_t h_{t-1} + b_t (h_{-1} = 0) by the log-depth scan."""
    return associative_scan(_combine, (a, bx), dim=1)[1]


def _lru_scan_sequential(a, bx):
    """The same recurrence one step at a time: S steps, for the tests."""
    h = torch.zeros_like(bx[:, 0])
    out = []
    for t in range(bx.shape[1]):
        h = a[:, t] * h + bx[:, t]
        out.append(h)
    return torch.stack(out, dim=1)


def rglru_block(p, x, *, state=None):
    """x: (B,S,d).  ``state``: None (training) or a dict with float32 h
    (B,dr) and conv (B,W-1,dr) of a decode step (S == 1) or a chunked
    prefill that carries it on, written in place with the new state.
    Returns (out, state): ``state`` is the dict passed in, or None."""
    xr = x @ p["wx"].to(x.dtype)
    gate = F.gelu(x @ p["wy"].to(x.dtype), approximate="tanh")
    conv_state = None if state is None else state["conv"]
    xc, new_conv = _conv1d_causal(xr, p["conv"], conv_state)

    r = torch.sigmoid(_block_diag(xc, p["wr"])).float()
    i = torch.sigmoid(_block_diag(xc, p["wi"])).float()
    log_a = -_C * F.softplus(p["lam"].float()) * r            # (B,S,dr)
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - torch.square(a), min=1e-12)) * (
        i * xc.float())

    if state is None:
        h = _lru_scan(a, gated)
    else:
        h0 = state["h"].float()
        if x.shape[1] == 1:
            h = a * h0[:, None] + gated
        else:  # chunked prefill with carried state
            h = _lru_scan(a, gated)
            # correct the scan with the carried initial state
            h = h + torch.exp(torch.cumsum(log_a, dim=1)) * h0[:, None]
        state["h"].copy_(h[:, -1])
        state["conv"].copy_(new_conv)

    out = (h.to(x.dtype) * gate) @ p["wo"].to(x.dtype)
    return out, state


def make_rglru_state(B, dr, device, conv_width: int = 4, lead: tuple = ()):
    """The zero state, float32 (as the JAX package makes it)."""
    return {
        "h": torch.zeros(lead + (B, dr), dtype=torch.float32, device=device),
        "conv": torch.zeros(lead + (B, conv_width - 1, dr),
                            dtype=torch.float32, device=device),
    }
