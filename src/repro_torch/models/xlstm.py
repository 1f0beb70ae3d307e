"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory), after
arXiv:2405.04517 -- the port of ``repro.models.xlstm``.  The xlstm-350m
config has d_ff = 0: the "MLP" lives inside the blocks themselves
(mLSTM up/down projection factor 2; sLSTM with a 4/3 gated MLP after the
cell).

mLSTM is evaluated *chunkwise* for training and prefill
(:func:`_chunk_mlstm`): within a chunk the quadratic (attention-like)
form, across chunks a recurrence on the (nh, dh, dh) matrix memory by
``recurrent.associative_scan`` (``jax.lax.associative_scan``'s odd /
even recursion, so the float32 sums are the JAX package's).  Its
three-operand contractions are written as an elementwise product and a
batched matmul, so no contraction order can build a ``(B, nc, T, T, nh,
dh)`` intermediate.  A decode step runs the exact stabilized recurrence
on the carried (C, n, m).  sLSTM has a genuine sequential dependency
through its recurrent weights ``r`` (the xLSTM paper notes it is not
parallelizable): a Python loop over time, in float32, takes the place of
``lax.scan``.

The state (mLSTM ``C``, ``n``, ``m``, ``conv``; sLSTM ``h``, ``c``,
``n``, ``m``) is float32 whatever the model's dtype, and the blocks
write it in place, as ``recurrent.rglru_block`` does.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import blocks as bl
from repro_torch.models.recurrent import _conv1d_causal, associative_scan


def _root(dh: int, dtype) -> torch.Tensor:
    """sqrt(dh) in ``dtype``, as the JAX package rounds its weak scalar
    (a CPU scalar: it costs no device copy)."""
    return torch.tensor(math.sqrt(dh), dtype=dtype)


# --------------------------------------------------------------------------
# mLSTM
# --------------------------------------------------------------------------

def init_mlstm(gen, d, nh, pf: float = 2.0, conv_width: int = 4,
               lead: tuple = ()):
    """Float32 weights; ``lead`` is a leading shape (the layer axis of a
    stacked segment)."""
    n = len(lead)
    pd = int(d * pf)
    dev = gen.device
    return {
        "ln": torch.ones(lead + (d,), device=dev),
        "w_up": bl.dense_init(gen, lead + (d, pd), n),
        "w_gate": bl.dense_init(gen, lead + (d, pd), n),
        "conv": bl.dense_init(gen, lead + (conv_width, pd), n).mul_(0.1),
        "wq": bl.dense_init(gen, lead + (pd, pd), n),
        "wk": bl.dense_init(gen, lead + (pd, pd), n),
        "wv": bl.dense_init(gen, lead + (pd, pd), n),
        "wif": bl.dense_init(gen, lead + (pd, 2 * nh), n),  # i & f gates
        "gn": torch.ones(lead + (pd,), device=dev),          # group norm
        "w_down": bl.dense_init(gen, lead + (pd, d), n),
    }


def _combine(left, right):
    """Two chunk memories in sequence: (f, C, n) then (f', C', n')."""
    fl, Cl, nl = left
    fr, Cr, nr = right
    return (fl + fr, Cr + torch.exp(fr)[..., None, None] * Cl,
            nr + torch.exp(fr)[..., None] * nl)


def _chunk_mlstm(q, k, v, logf, logi, chunk: int, init=None):
    """Chunkwise-parallel mLSTM. q,k,v: (B,S,nh,dh); logf/logi: (B,S,nh)
    float32; S a multiple of ``chunk``.

    Returns (h (B,S,nh,dh) in q's dtype, final_state (C, n, m)).
    Stabilization as in the JAX package: the per-sequence input-gate max
    M = max_s logi (per batch / head, at least the carried m0) is taken
    from every i weight and the denominator is floored at exp(-M).
    ``init``: optional carried stabilized state (C0, n0, m0) of a
    chunked prefill's continuation.  The scores are taken in q's dtype
    and cast to float32 after the division by sqrt(dh); the inter-chunk
    terms cast q to float32 first (the JAX package's orders)."""
    B, S, nh, dh = q.shape
    M = torch.amax(logi, dim=1, keepdim=True)            # (B,1,nh)
    if init is not None:
        M = torch.maximum(M, init[2][:, None])           # carried m0
    logi = logi - M
    floor = torch.exp(-M[:, 0])                          # (B,nh)

    nc = S // chunk
    qc = q.reshape(B, nc, chunk, nh, dh)
    kc = k.reshape(B, nc, chunk, nh, dh)
    vc = v.reshape(B, nc, chunk, nh, dh)
    fc = logf.reshape(B, nc, chunk, nh)
    ic = logi.reshape(B, nc, chunk, nh)
    kf, vf = kc.float(), vc.float()

    csum_f = torch.cumsum(fc, dim=2)                     # within-chunk decay
    tot_f = csum_f[:, :, -1]                             # (B,nc,nh)

    # ---- intra-chunk (quadratic with decay mask) ------------------------
    # weight for pair (t, s<=t): exp(csum_f[t] - csum_f[s] + logi[s]) <= 1.
    # Above the diagonal logw is a sum of -logf > 0 that overflows exp
    # over a long chunk (> 88 at chunk 256); the JAX package exponentiates
    # it and masks after, so its backward multiplies a 0 by inf and gives
    # NaN gradients there (ROADMAP section 3).  The port exponentiates the
    # causal half only: the same weights, finite gradients.
    logw = csum_f[:, :, :, None, :] - (csum_f - ic)[:, :, None, :, :]
    mask = torch.ones(chunk, chunk, dtype=torch.bool,
                      device=q.device).tril()[None, None, :, :, None]
    zero = torch.zeros((), device=q.device)
    w = torch.where(mask, torch.exp(torch.where(mask, logw, zero)),
                    zero)                                # (B,nc,T,T,nh)
    scores = torch.einsum("bcthd,bcshd->bctsh", qc, kc) / _root(dh, q.dtype)
    sw = scores.float() * w                              # (B,nc,T,S,nh)
    # (B,nc,nh,T,S) @ (B,nc,nh,S,dh) -> (B,nc,T,nh,dh)
    h_intra = torch.matmul(sw.permute(0, 1, 4, 2, 3),
                           vf.transpose(2, 3)).transpose(2, 3)
    norm_intra = sw.sum(dim=3)[..., None]                # (B,nc,T,nh,1)

    # ---- inter-chunk: recurrence over chunk memories --------------------
    # chunk memory delta: sum_s exp(tot_f - csum_f[s]) i_s k_s v_s^T
    decay_s = torch.exp(tot_f[:, :, None] - csum_f + ic)  # (B,nc,T,nh)
    kd = kf * decay_s[..., None]
    # (B,nc,nh,dh,S) @ (B,nc,nh,S,dh) -> (B,nc,nh,dh,dh)
    dC = torch.matmul(kd.permute(0, 1, 3, 4, 2), vf.transpose(2, 3))
    dn = kd.sum(dim=2)                                   # (B,nc,nh,dh)

    f_pre, C_pre, n_pre = associative_scan(
        _combine, (tot_f.movedim(1, 0), dC.movedim(1, 0), dn.movedim(1, 0)))
    # memory *before* chunk c = scanned value of chunk c-1; shift by one
    C_prev = torch.cat([torch.zeros_like(C_pre[:1]), C_pre[:-1]])
    n_prev = torch.cat([torch.zeros_like(n_pre[:1]), n_pre[:-1]])
    if init is not None:
        # carried state contributes exp(prefix_f + m0 - M) * (C0, n0)
        C0, n0, m0 = init
        prefix_f = torch.cat([torch.zeros_like(f_pre[:1]), f_pre[:-1]])
        w0 = torch.exp(prefix_f + (m0 - M[:, 0])[None])  # (nc,B,nh)
        C_prev = C_prev + w0[..., None, None] * C0.float()[None]
        n_prev = n_prev + w0[..., None] * n0.float()[None]
    C_prev = C_prev.movedim(0, 1)                        # (B,nc,nh,dh,dh)
    n_prev = n_prev.movedim(0, 1)
    # final carried state (stabilized at scale exp(-M))
    C_T, n_T = C_pre[-1], n_pre[-1]
    if init is not None:
        wT = torch.exp(f_pre[-1] + (m0 - M[:, 0]))
        C_T = C_T + wT[..., None, None] * C0.float()
        n_T = n_T + wT[..., None] * n0.float()
    final = (C_T, n_T, M[:, 0])

    # contribution of carried memory at step t: exp(csum_f[t]) q_t . C_prev
    root = _root(dh, torch.float32)
    qd = qc.float() * torch.exp(csum_f)[..., None]       # (B,nc,T,nh,dh)
    # (B,nc,nh,T,dh) @ (B,nc,nh,dh,dh) -> (B,nc,T,nh,dh)
    h_inter = torch.matmul(qd.transpose(2, 3), C_prev).transpose(2, 3) / root
    norm_inter = (qd * n_prev[:, :, None]).sum(dim=-1)[..., None] / root

    h = h_intra + h_inter
    norm = torch.abs(norm_intra + norm_inter)
    # denominator floor exp(-M): the stabilized max(|n^T q|, exp(-m)) form
    h = h / torch.maximum(norm, floor.reshape(B, 1, 1, nh, 1))
    return h.reshape(B, S, nh, dh).to(q.dtype), final


def mlstm_block(p, x, *, nh, chunk: int = 64, state=None,
                unread: bool = False):
    """x: (B,S,d) -> (out (B,S,d), state).  ``state``: None (training)
    or the float32 dict C (B,nh,dh,dh), n (B,nh,dh), m (B,nh), conv
    (B,W-1,pd) of a decode step (S == 1: the exact stabilized
    recurrence) or a prefill that carries it on (S > 1: the chunk form
    from it), written in place with the new state.  A prompt that is not
    a chunk multiple is padded with logf = 0 (no decay) and logi - 1e9
    (no input) on the padding.  ``unread``: the down projection ends a
    checkpoint region (``blocks.product``)."""
    B, S, d = x.shape
    xi = bl.rms_norm(x, p["ln"])
    up = xi @ p["w_up"].to(x.dtype)
    gate = F.silu(xi @ p["w_gate"].to(x.dtype))
    pd = up.shape[-1]
    dh = pd // nh

    conv_state = None if state is None else state["conv"]
    xc, new_conv = _conv1d_causal(up, p["conv"], conv_state)
    xc = F.silu(xc)

    q = (xc @ p["wq"].to(x.dtype)).reshape(B, S, nh, dh)
    k = (xc @ p["wk"].to(x.dtype)).reshape(B, S, nh, dh)
    v = (up @ p["wv"].to(x.dtype)).reshape(B, S, nh, dh)
    gates = (xc @ p["wif"].to(x.dtype)).float()
    logi, logf = gates[..., :nh], F.logsigmoid(gates[..., nh:])

    if state is None or S > 1:
        init = None
        if state is not None:
            init = (state["C"].float(), state["n"].float(),
                    state["m"].float())
        if S % chunk:
            pad = chunk - S % chunk
            pad_t = torch.arange(S + pad, device=x.device) >= S

            def padf(a):
                return F.pad(a, (0, 0) * (a.ndim - 2) + (0, pad))

            h, fin = _chunk_mlstm(padf(q), padf(k), padf(v), padf(logf),
                                  padf(logi) - 1e9 * pad_t[None, :, None],
                                  chunk, init=init)
            h = h[:, :S]
        else:
            h, fin = _chunk_mlstm(q, k, v, logf, logi, chunk, init=init)
        if state is not None:
            for name, new in zip(("C", "n", "m"), fin):
                state[name].copy_(new)
            state["conv"].copy_(new_conv)
    else:
        # exact stabilized single-step recurrence (xLSTM paper, eq. 15/25)
        C0, n0, m0 = (state[n].float() for n in ("C", "n", "m"))
        lf, li = logf[:, 0], logi[:, 0]                  # (B,nh)
        m = torch.maximum(lf + m0, li)
        f = torch.exp(lf + m0 - m)
        i = torch.exp(li - m)
        k0, v0, q0 = k[:, 0].float(), v[:, 0].float(), q[:, 0].float()
        C = f[..., None, None] * C0 + i[..., None, None] * (
            k0[..., :, None] * v0[..., None, :])
        n = f[..., None] * n0 + i[..., None] * k0
        root = _root(dh, torch.float32)
        num = torch.matmul(q0[:, :, None], C)[:, :, 0] / root
        den = torch.abs((q0 * n).sum(dim=-1)) / root
        den = torch.maximum(den, torch.exp(-m))[..., None]
        h = (num / den)[:, None].to(x.dtype)
        for name, new in (("C", C), ("n", n), ("m", m), ("conv", new_conv)):
            state[name].copy_(new)

    h = h.reshape(B, S, pd)
    h = bl.rms_norm(h, p["gn"]) * gate
    return x + bl.product(h, p["w_down"].to(x.dtype), unread=unread), state


def make_mlstm_state(B, d, nh, device, pf: float = 2.0, conv_width: int = 4,
                     lead: tuple = ()):
    """The JAX package's fresh state, float32: C, n and conv zeros, the
    stabilizer m at -30."""
    pd = int(d * pf)
    dh = pd // nh
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "C": torch.zeros(lead + (B, nh, dh, dh), **f32),
        "n": torch.zeros(lead + (B, nh, dh), **f32),
        "m": torch.full(lead + (B, nh), -30.0, **f32),
        "conv": torch.zeros(lead + (B, conv_width - 1, pd), **f32),
    }


# --------------------------------------------------------------------------
# sLSTM
# --------------------------------------------------------------------------

def init_slstm(gen, d, nh, mlp_pf: float = 4.0 / 3.0, lead: tuple = ()):
    """Float32 weights; ``r``'s fan-in is its head axis, as in the JAX
    package (``dense_init``'s axis 0 of ``(nh, dh, 4 dh)``)."""
    n = len(lead)
    dh = d // nh
    f = int(d * mlp_pf)
    dev = gen.device
    return {
        "ln": torch.ones(lead + (d,), device=dev),
        "w": bl.dense_init(gen, lead + (d, 4 * d), n),       # i,f,z,o
        "r": bl.dense_init(gen, lead + (nh, dh, 4 * dh), n).mul_(0.5),
        "gn": torch.ones(lead + (d,), device=dev),
        "ln2": torch.ones(lead + (d,), device=dev),
        "wg": bl.dense_init(gen, lead + (d, f), n),
        "wu": bl.dense_init(gen, lead + (d, f), n),
        "wd": bl.dense_init(gen, lead + (f, d), n),
    }


def slstm_block(p, x, *, nh, state=None, unread: bool = False):
    """Sequential sLSTM with exponential gating and block-diagonal
    recurrence (``r`` in float32), one step of the loop a token.
    ``state``: None (a zero start, m at -1e30) or the float32 dict h, c,
    n, m, each (B,d), written in place with the last step's.  Returns
    (out (B,S,d), state).  ``unread``: the FFN's down projection ends a
    checkpoint region (``blocks.product``)."""
    B, S, d = x.shape
    dh = d // nh
    xi = bl.rms_norm(x, p["ln"])
    pre = (xi @ p["w"].to(x.dtype)).float()               # (B,S,4d)

    if state is None:
        zeros = torch.zeros(B, d, dtype=torch.float32, device=x.device)
        h, c, n = zeros, zeros, zeros
        m = torch.full((B, d), -1e30, dtype=torch.float32, device=x.device)
    else:
        h, c, n, m = (state[k].float() for k in ("h", "c", "n", "m"))

    r = p["r"].float()
    hs = []
    for pre_t in pre.unbind(1):
        # the block-diagonal recurrence "bhd,hde->bhe" as one bmm over heads
        rec = torch.bmm(h.view(B, nh, dh).transpose(0, 1), r)
        zi, zf, zz, zo = (pre_t + rec.transpose(0, 1).reshape(B, 4 * d)
                          ).chunk(4, dim=-1)
        log_f = F.logsigmoid(zf)
        m_new = torch.maximum(log_f + m, zi)
        i = torch.exp(zi - m_new)
        f = torch.exp(log_f + m - m_new)
        c = f * c + i * torch.tanh(zz)
        n = f * n + i
        h = torch.sigmoid(zo) * c / torch.clamp(n, min=1.0)
        m = m_new
        hs.append(h)

    y = bl.rms_norm(torch.stack(hs, dim=1).to(x.dtype), p["gn"])
    y = x + y
    # gated MLP (the block's own FFN; config d_ff = 0)
    y = y + bl.swiglu(bl.rms_norm(y, p["ln2"]), p["wg"], p["wu"], p["wd"],
                      unread=unread)
    if state is not None:
        for name, new in (("h", h), ("c", c), ("n", n), ("m", m)):
            state[name].copy_(new)
    return y, state


def make_slstm_state(B, d, device, lead: tuple = ()):
    """The JAX package's fresh state, float32: h, c, n zeros, m at
    -1e30."""
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "h": torch.zeros(lead + (B, d), **f32),
        "c": torch.zeros(lead + (B, d), **f32),
        "n": torch.zeros(lead + (B, d), **f32),
        "m": torch.full(lead + (B, d), -1e30, **f32),
    }
