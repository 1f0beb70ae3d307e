"""AdamW with decoupled weight decay and global-norm gradient clipping
(the port of ``repro.optim.adamw``).

Functional and tree-generic over the port's parameter trees (nested
dicts and lists of tensors).  The optimizer state (m, v) is float32
whatever the parameter dtype; the update is computed in float32 and cast
back to the parameter's dtype, with no float32 master copy, as in the
JAX package.  Plain tensor operations per leaf: the JAX package computes
this in XLA, outside any Pallas kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.runtime import spans
from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float | Callable = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def adamw_init(params) -> dict:
    """Zero float32 m and v per leaf and an int32 step count, on the
    parameters' device."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    device = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree) -> torch.Tensor:
    """The float32 L2 norm over every leaf of ``tree``."""
    with spans.span("optim.global_norm"):
        return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                              for x in tree_leaves(tree)))


# words of a leaf updated at once in place: bounds the float32
# temporaries of the largest leaf (dbrx's expert stack: 1.06 B words)
INPLACE_CHUNK = 1 << 24


def adamw_update(cfg: AdamWConfig, grads, opt_state, params,
                 inplace: bool = False):
    """Returns ``(new_params, new_opt_state, metrics)``.  Decay applies
    to leaves of two or more dimensions only; a callable ``lr`` gets the
    new step count (an int32 tensor).  ``inplace`` writes the new
    parameters, m and v into the tensors of ``params`` and
    ``opt_state`` (and returns them), ``INPLACE_CHUNK`` words at a time:
    the same numbers, without a second copy of the state (the JAX
    trainer's buffer donation)."""
    with spans.span("optim.adamw"):
        return _adamw_update(cfg, grads, opt_state, params, inplace)


def _adamw_update(cfg, grads, opt_state, params, inplace):
    count = opt_state["count"] + 1
    gn = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gn, min=1e-12), max=1.0)
    lr = cfg.lr(count) if callable(cfg.lr) else cfg.lr
    c = count.float()
    bc1 = 1 - torch.pow(cfg.b1, c)
    bc2 = 1 - torch.pow(cfg.b2, c)

    def upd(g, m, v, p, decayed):
        g = g.float() * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
        mh = m / bc1
        vh = v / bc2
        step = mh / (torch.sqrt(vh) + cfg.eps)
        decay = cfg.weight_decay * p.float() if decayed else 0.0
        new_p = p.float() - lr * (step + decay)
        return new_p.to(p.dtype), m, v

    def upd_inplace(g, m, v, p):
        g = g.reshape(-1)
        fp, fm, fv = (t.view(-1) for t in (p, m, v))
        for lo in range(0, g.numel(), INPLACE_CHUNK):
            part = slice(lo, lo + INPLACE_CHUNK)
            new = upd(g[part], fm[part], fv[part], fp[part], p.dim() >= 2)
            for t, n in zip((fp, fm, fv), new):
                t[part].copy_(n)
        return p, m, v

    if inplace:
        out = tree_map(upd_inplace, grads, opt_state["m"], opt_state["v"],
                       params)
    else:
        out = tree_map(lambda g, m, v, p: upd(g, m, v, p, p.dim() >= 2),
                       grads, opt_state["m"], opt_state["v"], params)
    pick = lambda i: tree_map(lambda o: o[i], out,  # noqa: E731
                              is_leaf=lambda x: isinstance(x, tuple))
    metrics = {"grad_norm": gn,
               "lr": torch.as_tensor(lr, dtype=torch.float32,
                                     device=gn.device)}
    return pick(0), {"m": pick(1), "v": pick(2), "count": count}, metrics
