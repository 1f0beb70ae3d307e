"""Plain PyTorch reference of the decoder that the dense and MoE
configurations run: the equations, written out, in float32 (or, for
the control, with every matrix product's operands rounded to fp8).

It imports nothing of the program and reads nothing the program made:
its weights are the benchmark's own seeded draws (``perfbench.weights``,
in the layout :func:`leaf_specs` gives), its inputs the benchmark's.

The model, as the configuration file states it and the program runs
it: token embeddings times sqrt(d_model); per layer an RMSNorm (eps
1e-6, float32), GQA self-attention (q / k / v projections with optional
biases, rotary embeddings on the half-split head dim at ``rope_base``,
scores scaled by 1/sqrt(dh), causal softmax, the output projection) on
the residual, an RMSNorm, then a SwiGLU MLP or the routed experts on
the residual; a final RMSNorm and the output head (the embedding,
transposed, when tied).  The routed experts: router logits, a float32
softmax, the top k by a stable descending sort, the k gates normalised
to sum 1 (``router_norm``), each token's output the gated sum of its k
experts' SwiGLU outputs.  Every routed pair is computed (dropless, as
DBRX's own MoE is); the configuration's capacity factor is E / k, at
which the program's capacity dispatch keeps every pair too.  The
Switch load-balance loss ``E * sum_e mean(probs_e) * share_e`` is
summed over the MoE layers and weighted by ``aux_loss_weight``.  The
training loss is the mean next-token cross-entropy, in float32, plus
that weighted aux.

Float32 products here run with TF32 off (:func:`exact_matmuls`).
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

EPS = 1e-6
FP8_MAX = 448.0                  # largest finite float8 e4m3 value
PRECISIONS = ("float32", "fp8")


@contextlib.contextmanager
def exact_matmuls():
    """Float32 matrix products in float32, not TF32, inside the block."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def head_dim(m: dict) -> int:
    return m.get("d_head") or m["d_model"] // m["n_heads"]


def leaf_specs(m: dict) -> list:
    """``[(name, shape, init), ...]`` in draw order; ``init`` is
    ``("normal", std)``, ``("ones",)`` or ``("zeros",)``.  Per-layer
    leaves are stacked on a leading layer axis."""
    d, H, K, L, V = (m["d_model"], m["n_heads"], m["n_kv_heads"],
                     m["n_layers"], m["vocab"])
    dh = head_dim(m)

    def normal(fan_in):
        return ("normal", fan_in ** -0.5)

    specs = [("embed", (V, d), ("normal", 0.02))]
    if not m["tie_embeddings"]:
        specs.append(("lm_head", (d, V), normal(d)))
    specs += [("final_norm", (d,), ("ones",)),
              ("ln1", (L, d), ("ones",)),
              ("wq", (L, d, H * dh), normal(d)),
              ("wk", (L, d, K * dh), normal(d)),
              ("wv", (L, d, K * dh), normal(d)),
              ("wo", (L, H * dh, d), normal(H * dh))]
    if m["qkv_bias"]:
        specs += [("bq", (L, H * dh), ("zeros",)),
                  ("bk", (L, K * dh), ("zeros",)),
                  ("bv", (L, K * dh), ("zeros",))]
    specs.append(("ln2", (L, d), ("ones",)))
    moe = m.get("moe")
    if moe:
        E, fe = moe["n_experts"], moe["d_ff_expert"]
        specs += [("router", (L, d, E), normal(d)),
                  ("wg", (L, E, d, fe), normal(d)),
                  ("wu", (L, E, d, fe), normal(d)),
                  ("wd", (L, E, fe, d), normal(fe))]
    else:
        f = m["d_ff"]
        specs += [("wg", (L, d, f), normal(d)),
                  ("wu", (L, d, f), normal(d)),
                  ("wd", (L, f, d), normal(f))]
    return specs


# --------------------------------------------------------------------------
# precision
# --------------------------------------------------------------------------

def _q8(x):
    """``x`` rounded to float8 e4m3, one scale for the tensor (its largest
    magnitude at 448), back in float32."""
    s = x.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


def fp8(x):
    """:func:`_q8` of ``x``; the gradient passes straight through."""
    xd = x.detach()
    return x + (_q8(xd) - xd)


class _Fp8Product(torch.autograd.Function):
    """``a (..., k) @ b (k, n)`` on fp8-rounded operands, the gradient
    straight through; it keeps only ``a`` and ``b``, rounding them again
    in the backward (a rounded copy of every weight would not fit beside
    the float32 state of a full-width model)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _q8(a) @ _q8(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        qa, qb = _q8(a), _q8(b)
        return (g @ qb.T, qa.reshape(-1, a.shape[-1]).T
                @ g.reshape(-1, g.shape[-1]))


def _round(prec: str, *xs):
    if prec == "fp8":
        return tuple(fp8(x) for x in xs)
    return xs


def mm(a, b, prec: str):
    """``a @ b`` for a weight ``b`` of two dimensions."""
    if prec == "fp8":
        return _Fp8Product.apply(a, b)
    return a @ b


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

def rms_norm(x, scale):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + EPS) * scale


def rope(x, positions, base: float):
    """x (B, S, heads, dh), positions (S,): the half-split rotation."""
    dh = x.shape[-1]
    freqs = 1.0 / (base ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                         device=x.device) / dh))
    ang = (positions.float()[:, None] * freqs)[None, :, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    cos, sin = ang.cos(), ang.sin()
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(p, l: int, h, m: dict, prec: str):
    B, S, _ = h.shape
    H, K, dh = m["n_heads"], m["n_kv_heads"], head_dim(m)
    q, k, v = (mm(h, p[w][l], prec) for w in ("wq", "wk", "wv"))
    if m["qkv_bias"]:
        q, k, v = q + p["bq"][l], k + p["bk"][l], v + p["bv"][l]
    pos = torch.arange(S, device=h.device)
    q = rope(q.view(B, S, H, dh), pos, m["rope_base"])
    k = rope(k.view(B, S, K, dh), pos, m["rope_base"])
    v = v.view(B, S, K, dh)
    q = q.view(B, S, K, H // K, dh)
    qr, kr = _round(prec, q, k)
    scores = torch.einsum("bskgh,btkh->bkgst", qr, kr) / math.sqrt(dh)
    causal = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), -1)
    pr, vr = _round(prec, probs, v)
    o = torch.einsum("bkgst,btkh->bskgh", pr, vr).reshape(B, S, H * dh)
    return mm(o, p["wo"][l], prec)


def swiglu(x, wg, wu, wd, prec: str):
    return mm(F.silu(mm(x, wg, prec)) * mm(x, wu, prec), wd, prec)


def experts(p, l: int, h, m: dict, prec: str):
    """The routed experts over h (B, S, d): ``(out, aux)``."""
    moe = m["moe"]
    E, k = moe["n_experts"], moe["top_k"]
    B, S, d = h.shape
    x = h.reshape(B * S, d)
    probs = torch.softmax(mm(x, p["router"][l], prec), dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, chosen = top.values[:, :k], top.indices[:, :k]
    if moe.get("router_norm", True):
        gates = gates / gates.sum(-1, keepdim=True)
    share = torch.bincount(chosen.reshape(-1), minlength=E).float() \
        / (x.shape[0] * k)
    aux = E * (probs.mean(0) * share).sum()
    out = torch.zeros_like(x)
    for e in range(E):
        tok, slot = (chosen == e).nonzero(as_tuple=True)
        if tok.numel():
            y = swiglu(x[tok], p["wg"][l, e], p["wu"][l, e], p["wd"][l, e],
                       prec)
            out = out.index_add(0, tok, y * gates[tok, slot, None])
    return out.view(B, S, d), aux


def forward(p: dict, tokens, m: dict, prec: str = "float32"):
    """Logits (B, S, vocab) of every position of ``tokens`` (B, S), and
    the MoE layers' summed aux loss (0 without them)."""
    if prec not in PRECISIONS:
        raise ValueError(f"precision {prec!r}; known: {PRECISIONS}")
    x = p["embed"][tokens] * math.sqrt(m["d_model"])
    aux = x.new_zeros(())
    for l in range(m["n_layers"]):
        x = x + attention(p, l, rms_norm(x, p["ln1"][l]), m, prec)
        h = rms_norm(x, p["ln2"][l])
        if m.get("moe"):
            f, a = experts(p, l, h, m, prec)
            aux = aux + a
        else:
            f = swiglu(h, p["wg"][l], p["wu"][l], p["wd"][l], prec)
        x = x + f
    x = rms_norm(x, p["final_norm"])
    head = p["embed"].T if m["tie_embeddings"] else p["lm_head"]
    return mm(x, head, prec), aux


def token_losses(logits, labels):
    """Next-token cross-entropy of every position, float32."""
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.logsumexp(logits, -1) - ll


def loss_and_grads(p: dict, tokens, labels, m: dict, prec: str = "float32"):
    """``(loss, grads)``: the mean cross-entropy over every token plus the
    weighted aux, and its gradient in every leaf of ``p`` (float32
    leaves).  A dense model runs one row at a time, its gradients summed,
    so that a full-width float32 pass fits beside its state; an MoE
    layer's aux and routing read the whole batch, so an MoE model runs
    in one block."""
    B = tokens.shape[0]
    rows = B if m.get("moe") else 1
    live = {n: t.detach().requires_grad_() for n, t in p.items()}
    grads = None
    total = 0.0
    n_tok = tokens.numel()
    for lo in range(0, B, rows):
        logits, aux = forward(live, tokens[lo:lo + rows], m, prec)
        part = token_losses(logits, labels[lo:lo + rows]).sum() / n_tok \
            + m["aux_loss_weight"] * aux
        del logits
        got = torch.autograd.grad(part, list(live.values()),
                                  allow_unused=True)
        got = {n: torch.zeros_like(t) if g is None else g
               for (n, t), g in zip(live.items(), got)}
        if grads is None:
            grads = got
        else:
            for n, g in got.items():
                grads[n] += g
        total += part.item()
        del got, part
    return total, grads
