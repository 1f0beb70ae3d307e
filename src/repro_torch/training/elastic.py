"""Fault tolerance at step granularity: straggler quorum, delivery
failure, elastic restart (the port of ``repro.training.elastic``).

A rank that is slow (a straggler) drops out of the step by **quorum
data parallelism**: the step proceeds with whichever kernels of the
kernel axis contributed, reweighting the mean by the live count.  A
rank whose *communication* failed -- a reliable put exhausted its
retransmit budget and latched the sticky ``ERR_RETRY_EXHAUSTED`` bit --
drops out the same way (:func:`delivery_live_mask`), so one bad link
degrades the batch instead of corrupting the mean with a
half-delivered contribution.  A dead host is handled by
checkpoint/restart (:mod:`repro_torch.checkpoint`, the launcher's retry
loop); restarting on another kernel count is a restore into a trainer
of that count, since checkpoints hold global tensors (the JAX
package's ``reshard_state`` places them on a new mesh instead).
"""

from __future__ import annotations

import torch

from repro_torch.core.state import ERR_RETRY_EXHAUSTED, ShoalContext
from repro_torch.tree import tree_map


def quorum_mean_grads(ctx: ShoalContext, grads, live: torch.Tensor):
    """Mean-of-live gradient reduction over the kernel axis.

    ``grads``: leaves stacked ``(K, ...)`` per kernel; ``live``: ``(K,)``
    float {0, 1}.  Dead kernels contribute zero; the sum is renormalized
    by the live count, so every kernel's row is the mean over the
    survivors (float32).  Returns ``(grads, n_live (K,))``.  A reduction
    over the kernel axis, as the reference's ``psum`` (an XLA
    all-reduce, not Shoal traffic): it counts no exchange."""
    if live.shape != (ctx.num_kernels,):
        raise ValueError(f"live must be ({ctx.num_kernels},), got "
                         f"{tuple(live.shape)}")
    n_live = live.sum().expand(ctx.num_kernels)

    def one(g):
        w = live.reshape((-1,) + (1,) * (g.dim() - 1))
        g = g.float() * w
        total = g.sum(0, keepdim=True) / torch.clamp(n_live[0], min=1.0)
        return total.expand_as(g).to(g.dtype)

    return tree_map(one, grads), n_live


def delivery_live_mask(live: torch.Tensor, error: torch.Tensor,
                       bits: int = ERR_RETRY_EXHAUSTED) -> torch.Tensor:
    """Fold comm-delivery failure into a quorum live mask.

    ``live`` is the heartbeat mask (per kernel, float {0, 1}); ``error``
    the kernels' sticky PGAS error words (``PgasState.error``).  A
    kernel whose reliable put gave up (``ERR_RETRY_EXHAUSTED`` by
    default -- pass a wider ``bits`` mask to also drop on e.g.
    ``ERR_CRC``) is treated as dead for this step's
    :func:`quorum_mean_grads`: its gradient may be built on partially
    delivered data, so excluding it is the safe degradation."""
    failed = (error.to(torch.int32) & bits) != 0
    return live * torch.where(failed, 0.0, 1.0).to(live.dtype)


class FailureInjector:
    """Deterministic failure schedule for tests/examples: fail the step
    the first time each listed step number is reached."""

    def __init__(self, fail_at: set[int]):
        self.fail_at = set(fail_at)
        self.fired: set[int] = set()

    def check(self, step: int):
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise RuntimeError(f"injected failure at step {step}")
