"""The trainer: a train step with a selectable comm backend (the port of
``repro.training.train``).

Two backends, both computing the same math (tested against each other):

* ``xla`` -- the whole batch in one loss-and-grad on the device (the
  JAX package's one-program GSPMD step; the name is kept so the
  launcher's flags match).  ``microbatches > 1`` loops over equal slices
  of the batch and accumulates ``loss / n``.  A model built with
  ``ep=ExpertMesh(ctx, data=D)`` trains expert-parallel, as the JAX
  ``Trainer`` trains a mesh model: its MoE layers run the island over
  ``ctx``'s kernels, forward and backward on the ring collectives
  (:mod:`repro_torch.models.moe`); that is the step's only Shoal
  traffic.  The ``shoal`` backend refuses such a model, as the JAX
  package's shoal step fails on it.
* ``shoal`` -- the paper-faithful path: the trainer holds a
  ``ShoalContext`` of K kernels, the data-parallel members.  Member k
  computes the loss and gradient of rows ``[k B/K, (k+1) B/K)`` of the
  batch, and every gradient leaf, stacked ``(K, ...)`` in float32, goes
  through ``core.collectives.ring_all_reduce`` -- one ring-kernel launch
  and ``2(K - 1)`` exchanges a leaf -- then is divided by K and cast
  back.  Optional int8 error-feedback compression sends the int32
  payload and the ``(K, 1)`` scale through the ring instead.

Parameters and optimizer state stay replicated: one copy, updated from
row 0 of each all-reduced leaf (every row is equal).  The K members run
one after another on the one device.  Losses are differentiated through
``Model.loss``, whose attention is the plain route (the flash kernel has
no backward).  The JAX package's XLA sharding helpers
(``state_pspecs``, ``state_shardings``, ``batch_shardings``) are not
ported (ROADMAP).  Its buffer donation is ``TrainerConfig.donate``, off
by default here (the JAX default is on): the update is written into
the state's own tensors, so a step holds one copy of the optimizer
state.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core import collectives as coll
from repro_torch.core.state import ShoalContext
from repro_torch.models.model import Model
from repro_torch.optim import adamw as aw
from repro_torch.optim import dist as od
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

BACKENDS = ("xla", "shoal")


def _grad(loss, leaves) -> list:
    """d loss / d leaf for every leaf; a leaf the loss does not read (the
    audio family's untied token embedding) gets zeros, as
    ``jax.grad`` gives it."""
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for g, p in zip(grads, leaves)]


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: torch.Tensor            # () int32
    ef_residual: Any = None       # per member int8 error-feedback
                                  # buffers, (K, ...) float32, or None


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    comm_backend: str = "xla"       # xla | shoal
    microbatches: int = 1
    grad_compression: bool = False  # int8 EF on the shoal sync
    donate: bool = False            # the step updates the state in place


class Trainer:
    """``kernels``: the ``shoal`` backend's data-parallel members (the
    kernel axis of its ``ShoalContext``, on the model's device)."""

    def __init__(self, model: Model, opt_cfg: aw.AdamWConfig,
                 tcfg: TrainerConfig = TrainerConfig(), kernels: int = 1):
        if tcfg.comm_backend not in BACKENDS:
            raise ValueError(f"comm_backend must be one of {BACKENDS}, got "
                             f"{tcfg.comm_backend!r}")
        if tcfg.grad_compression and tcfg.comm_backend != "shoal":
            raise ValueError("grad_compression compresses the shoal "
                             "backend's ring all-reduce; the xla backend "
                             "has no sync to compress")
        if tcfg.comm_backend == "shoal" and model._island is not None:
            raise ValueError(
                "the shoal backend does not train an expert-parallel model "
                "(Model(..., ep=)): its members would nest the island's "
                "kernels in theirs, which the JAX package's shoal step "
                "cannot do either (its shard_map over the data axis meets "
                "the island's over the whole mesh); train it with the xla "
                "backend")
        self.model = model
        self.opt_cfg = opt_cfg
        self.tcfg = tcfg
        self.ctx = (ShoalContext(kernels, device=model.device)
                    if tcfg.comm_backend == "shoal" else None)

    @property
    def kernels(self) -> int:
        return self.ctx.num_kernels if self.ctx is not None else 1

    # -- state ----------------------------------------------------------------

    def init_state(self, gen: torch.Generator) -> TrainState:
        """Random weights from ``gen`` (a generator on the model's
        device), zero optimizer state."""
        return self.state_for(self.model.init(gen))

    def state_for(self, params) -> TrainState:
        """The step-0 state of ``params``."""
        ef = None
        if self.tcfg.grad_compression:
            ef = tree_map(lambda r: r.expand(self.kernels, *r.shape).clone(),
                          od.make_error_feedback(params))
        return TrainState(params=params, opt_state=aw.adamw_init(params),
                          step=torch.zeros((), dtype=torch.int32,
                                           device=self.model.device),
                          ef_residual=ef)

    # -- losses ----------------------------------------------------------------

    def value_and_grad(self, params, batch):
        """``(loss, grads)`` of ``batch`` (all its rows): the loss
        detached, the gradients in each parameter's dtype.  With
        ``microbatches = n > 1``, the mean of n equal slices' losses,
        each slice's gradient of ``loss / n`` summed in float32."""
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        live = tree_unflatten(params, leaves)
        n = self.tcfg.microbatches
        if n == 1:
            loss = self.model.loss(live, batch)
            grads = _grad(loss, leaves)
            return loss.detach(), tree_unflatten(params, grads)
        B = next(iter(batch.values())).shape[0]
        if B % n:
            raise ValueError(f"batch of {B} rows does not split into {n} "
                             "microbatches")
        mb = B // n
        total, acc = None, None
        for i in range(n):
            part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            loss = self.model.loss(live, part)
            grads = _grad(loss / n, leaves)
            total = loss.detach() if total is None else total + loss.detach()
            acc = ([g.float() for g in grads] if acc is None
                   else [a + g.float() for a, g in zip(acc, grads)])
        return total / n, tree_unflatten(
            params, [a.to(p.dtype) for a, p in zip(acc, leaves)])

    def member_grads(self, params, batch):
        """The shoal members' ``[(loss, grads), ...]``, member k on rows
        ``[k B/K, (k+1) B/K)`` of ``batch``."""
        K = self.kernels
        B = next(iter(batch.values())).shape[0]
        if B % K:
            raise ValueError(f"batch of {B} rows does not split over {K} "
                             "data-parallel members")
        rows = B // K
        return [self.value_and_grad(
                    params, {k: v[m * rows:(m + 1) * rows]
                             for k, v in batch.items()})
                for m in range(K)]

    # -- the shoal sync ----------------------------------------------------------

    @torch.no_grad()
    def sync(self, member_grads: list, residual=None):
        """Ring all-reduce every leaf of the members' gradients over the
        kernel axis and average them: ``(synced grads, new residual)``.
        Uncompressed, each leaf's ``(K, ...)`` float32 stack goes through
        the ring once and comes back in the leaf's dtype; compressed,
        each member's ``grads + residual`` is quantized to int8, the
        int32 payloads and the ``(K, 1)`` scales each go through the
        ring, and the result is float32.  ``member_grads`` is emptied and
        each member's leaf released once stacked, so the members'
        gradients and the ring's buffers are not all held at once."""
        ctx, K = self.ctx, self.kernels
        like = tree_map(lambda _: 0, member_grads[0])     # the structure
        per_member = [tree_leaves(g) for g in member_grads]
        member_grads.clear()
        if residual is None:
            out = []
            for i, g0 in enumerate(per_member[0]):
                stack = torch.stack([m[i].float() for m in per_member])
                for m in per_member:
                    m[i] = None
                red = coll.ring_all_reduce(ctx, stack)
                del stack
                out.append((red[0] / K).to(g0.dtype))
            return tree_unflatten(like, out), None
        res_rows = tree_leaves(residual)
        out, new_res = [], []
        for i in range(len(per_member[0])):
            parts = [od.ef_compress_tree(m[i], res_rows[i][k])
                     for k, m in enumerate(per_member)]
            for m in per_member:
                m[i] = None
            q = torch.stack([q.to(torch.int32) for (q, _), _ in parts])
            s = torch.stack([s for (_, s), _ in parts])[:, None]
            new_res.append(torch.stack([r for _, r in parts]))
            del parts
            red = coll.ring_all_reduce(ctx, q)
            smax = coll.ring_all_reduce(ctx, s)[:, 0] / K
            out.append(red[0].float() * smax[0] / K)
        return tree_unflatten(like, out), tree_unflatten(residual, new_res)

    # -- the step ---------------------------------------------------------------

    def grads(self, state: TrainState, batch):
        """``(loss, grads, new ef_residual)``: the whole batch's loss and
        the gradients the update applies (the shoal members' synced
        mean, their loss the mean of the members', as ``pmean``)."""
        if self.ctx is None:
            loss, grads = self.value_and_grad(state.params, batch)
            return loss, grads, state.ef_residual
        members = self.member_grads(state.params, batch)
        losses = [m[0] for m in members]
        trees = [m[1] for m in members]
        del members                  # sync empties trees as it goes
        grads, res = self.sync(trees, state.ef_residual)
        return sum(losses) / len(losses), grads, res

    @torch.no_grad()
    def apply_update(self, state: TrainState, grads, loss, ef_residual=None):
        new_params, new_opt, metrics = aw.adamw_update(
            self.opt_cfg, grads, state.opt_state, state.params,
            inplace=self.tcfg.donate)
        metrics["loss"] = loss
        return TrainState(params=new_params, opt_state=new_opt,
                          step=state.step + 1,
                          ef_residual=ef_residual), metrics

    def step(self, state: TrainState, batch):
        """One train step: ``(new state, metrics)``; ``state`` is left
        as it was, unless ``donate`` hands its parameters and optimizer
        state to the new one, updated in place."""
        loss, grads, res = self.grads(state, batch)
        return self.apply_update(state, grads, loss, res)

    def make_train_step(self):
        return self.step
