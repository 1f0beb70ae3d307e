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
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def adamw_update(cfg: AdamWConfig, grads, opt_state, params):
    """Returns ``(new_params, new_opt_state, metrics)``.  Decay applies
    to leaves of two or more dimensions only; a callable ``lr`` gets the
    new step count (an int32 tensor)."""
    count = opt_state["count"] + 1
    gn = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gn, min=1e-12), max=1.0)
    lr = cfg.lr(count) if callable(cfg.lr) else cfg.lr
    c = count.float()
    bc1 = 1 - torch.pow(cfg.b1, c)
    bc2 = 1 - torch.pow(cfg.b2, c)

    def upd(g, m, v, p):
        g = g.float() * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
        mh = m / bc1
        vh = v / bc2
        step = mh / (torch.sqrt(vh) + cfg.eps)
        decay = cfg.weight_decay * p.float() if p.dim() >= 2 else 0.0
        new_p = p.float() - lr * (step + decay)
        return new_p.to(p.dtype), m, v

    out = tree_map(upd, grads, opt_state["m"], opt_state["v"], params)
    pick = lambda i: tree_map(lambda o: o[i], out,  # noqa: E731
                              is_leaf=lambda x: isinstance(x, tuple))
    metrics = {"grad_norm": gn,
               "lr": torch.as_tensor(lr, dtype=torch.float32,
                                     device=gn.device)}
    return pick(0), {"m": pick(1), "v": pick(2), "count": count}, metrics
