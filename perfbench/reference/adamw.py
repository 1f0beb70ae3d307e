"""Plain AdamW, the optimizer the training mixes state: the gradient
clipped to a global L2 norm, bias-corrected first and second moments in
float32, decoupled weight decay on every leaf of two or more dimensions,
a constant learning rate.  Updates the float32 parameters in place,
a chunk of words at a time.

``steps == 2`` keeps no second moment between the steps: after one
step it is ``(1 - b2) / (1 - b1)^2 * m^2`` exactly, so two steps of a
model whose parameters, first moments and one gradient fill most of
the card still fit beside them.
"""

from __future__ import annotations

import torch

CHUNK = 1 << 26                  # words updated at once


def run(p: dict, grad_fn, steps: int, opt: dict, watch=None) -> dict:
    """``steps`` AdamW steps on ``p`` (name -> float32 tensor), each from
    ``grad_fn(p, i) -> (loss, grads)`` (step ``i`` from 0).  Returns the
    losses and the first step's gradient norm a leaf, as the update
    reads it (after clipping); ``watch(name, gradient)`` sees that
    gradient too."""
    b1, b2, eps = opt["b1"], opt["b2"], opt["eps"]
    lr, wd, clip = opt["lr"], opt["weight_decay"], opt["grad_clip"]
    m, v = {}, {}
    losses, first = [], {}
    for t in range(1, steps + 1):
        loss, g = grad_fn(p, t - 1)
        losses.append(loss)
        gn = torch.sqrt(sum(x.square().sum() for x in g.values()))
        scale = torch.clamp(clip / torch.clamp(gn, min=1e-12), max=1.0)
        bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
        for name in list(g):
            gl, pl = g.pop(name).contiguous(), p[name]
            if t == 1:
                first[name] = (gl * scale).norm().item()
                if watch is not None:
                    watch(name, gl * scale)
            keep = t < steps
            m_new = torch.empty_like(gl) if keep else None
            v_new = torch.empty_like(gl) if keep and steps > 2 else None
            gf, pf = gl.view(-1), pl.view(-1)
            for lo in range(0, gf.numel(), CHUNK):
                s = slice(lo, lo + CHUNK)
                gs = gf[s] * scale
                if t == 1:
                    mc = (1 - b1) * gs
                    vc = (1 - b2) * gs.square()
                else:
                    mo = m[name].view(-1)[s]
                    vo = (v[name].view(-1)[s] if name in v
                          else (1 - b2) / (1 - b1) ** 2 * mo.square())
                    mc = b1 * mo + (1 - b1) * gs
                    vc = b2 * vo + (1 - b2) * gs.square()
                step = (mc / bc1) / (torch.sqrt(vc / bc2) + eps)
                if pl.dim() >= 2:
                    step = step + wd * pf[s]
                pf[s] -= lr * step
                if m_new is not None:
                    m_new.view(-1)[s] = mc
                if v_new is not None:
                    v_new.view(-1)[s] = vc
            del gl
            m.pop(name, None)
            v.pop(name, None)
            if m_new is not None:
                m[name] = m_new
            if v_new is not None:
                v[name] = v_new
    return {"losses": losses, "grad_norms": first}
