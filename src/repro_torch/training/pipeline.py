"""Pipeline parallelism on Shoal Medium-AM handoffs, GPipe style (the
port of ``repro.training.pipeline``).

Stage ``i`` lives on kernel ``i`` of the kernel axis.  Microbatches
stream through ``M + n - 1`` ticks; each tick every kernel runs its stage
on what arrived last tick (stage 0 on the next microbatch) and hands its
output one kernel along -- one exchange, a gather over the kernel axis,
as the reference's single ``lax.ppermute`` per tick.  The last stage's
outputs are broadcast back to every kernel.  Autograd through the ticks
gives the backward schedule (the transpose of a handoff is the reverse
handoff), as autodiff through the reference's scan does.

``stage_fn(stage_params, x)`` is any per-stage function with matching
x shapes (e.g. a slice of a layer stack).
"""

from __future__ import annotations

import torch

from repro_torch.core import collectives as coll
from repro_torch.core import ops
from repro_torch.core.state import ShoalContext
from repro_torch.tree import tree_map, tree_unstack


def pipeline_apply(ctx: ShoalContext, stage_fn, stage_params,
                   mbs: torch.Tensor) -> torch.Tensor:
    """Run ``mbs`` (M, mb, ...) microbatches through ``n =
    ctx.num_kernels`` stages.

    ``stage_params``: tree whose leaves have a leading n-stage dim
    (stage i's slice is kernel i's).  Returns the last stage's output
    for every microbatch, (M, mb, ...), as every kernel holds it after
    the broadcast.  Exchanges: one per tick, then the broadcast's
    ``2(n - 1)``; a backward through the result adds one reverse
    handoff a tick but the last (whose handoff no stage reads) and
    the broadcast's ``n - 1`` payload hops (its validity flags carry
    no cotangent)."""
    n = ctx.num_kernels
    M = mbs.shape[0]
    perm = [(i, i + 1) for i in range(n - 1)]          # stage i -> i+1
    stages = tree_unstack(stage_params, n)
    inbox = torch.zeros((n,) + mbs.shape[1:], dtype=mbs.dtype,
                        device=mbs.device)
    done = []
    for t in range(M + n - 1):
        ins = [mbs[min(t, M - 1)]] + [inbox[i] for i in range(1, n)]
        outs = torch.stack([stage_fn(stages[i], ins[i]) for i in range(n)])
        inbox = ops._permute(ctx, perm, outs)
        done.append(outs[n - 1])
    # the last stage's outputs of ticks n-1 .. M+n-2 are microbatches
    # 0 .. M-1; broadcast them from the last kernel
    valid = torch.stack(done[n - 1:])
    return coll.broadcast_from(ctx, valid.expand(n, *valid.shape),
                               root=n - 1)[0]


def split_stages(params_stacked, n_stages: int):
    """Split a layer-stacked param tree (L, ...) into (n_stages, L/n, ...)."""
    def one(x):
        L = x.shape[0]
        if L % n_stages:
            raise ValueError(f"{L} layers do not split into {n_stages} "
                             "stages")
        return x.reshape((n_stages, L // n_stages) + tuple(x.shape[1:]))
    return tree_map(one, params_stacked)
