"""Mixture-of-experts with expert parallelism over the kernel axis (the
port of ``repro.models.moe``; dbrx).

Routing is top-k softmax gating; experts are SwiGLU MLPs with stacked
weights ``(E, d, d_ff_e)``.  Dispatch is sort-based, as in the JAX
package: pairs are ranked within their expert by a stable sort, up to a
static capacity per expert are gathered, the experts run as batched
matrix products over the slots, and the results are combined back onto
their tokens.  Pairs past the capacity are dropped.

:func:`moe_ffn` is the single-device path, the JAX package's oracle and
its serving path.  :func:`moe_routed_island` is expert parallelism over
the ``K`` kernels of a :class:`~repro_torch.core.state.ShoalContext`:
the JAX mesh's ``model`` axis is the kernel axis (kernel ``k`` holds the
expert slab ``[k E/K, (k+1) E/K)``, a view of the stacked leaf) and its
``data`` axis is a batch dimension of the island (:class:`ExpertMesh`).
Every ``(data, model)`` shard keeps its own token count, and so its own
capacity.  The combine runs on the port's collectives, one call for
every data group at once:

* ``psum``: tokens replicated over the kernels; one ring all-reduce of
  the float32 combine;
* ``rs``: tokens sequence-sharded; a ring all-gather of the tokens in
  the compute dtype, a ring reduce-scatter of the float32 combine;
* ``a2a``: tokens sequence-sharded; one vectored all-to-all sends every
  pair to its expert's owner (the expert ids ride in the same exchange
  as a bitcast meta lane, :mod:`repro_torch.actors.coalesce`) and one
  brings the results home.

The island is differentiable.  Its collectives carry autograd edges
whose backward is the adjoint collective on the same ring kernel
(:mod:`repro_torch.core.collectives`), and an input that every kernel
reads whole gets its cotangent summed across the kernels by one ring
all-reduce, where the JAX package's ``shard_map`` transpose inserts a
``psum``: the psum dispatch's replicated tokens and the router.  The
expert slabs are each one kernel's, so they are not reduced; the data
groups are a loop on each kernel, so sums over them stay local (the
JAX mesh reduces the slabs over its ``data`` axis instead).  The
backward's collectives are therefore

    the adjoint of every forward collective whose output reaches the
    loss + one all-reduce for the tokens (psum only) + one for the
    router,

each counted in ``ctx.exchanges`` and ``ctx.collectives`` as a forward
call of its kind.  A loss that leaves ``aux`` out skips the adjoint of
its all-reduce.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.actors.coalesce import pack_meta_lane, unpack_meta_lane
from repro_torch.core import collectives as coll
from repro_torch.core.state import ShoalContext
from repro_torch.models import blocks as bl
from repro_torch.runtime import spans

ROUTED = ("router", "wg", "wu", "wd")      # the island's leaves


@dataclasses.dataclass(frozen=True)
class MoEDims:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0            # deepseek-v2 shared experts
    capacity_factor: float = 1.25
    router_norm: bool = True     # normalize top-k gate weights to sum 1
    dispatch: str = "psum"       # psum | a2a | rs  (EP combine strategy)
                                 # rs: tokens S-sharded at the boundary;
                                 # all-gather in, f32 reduce-scatter out


@dataclasses.dataclass(frozen=True)
class ExpertMesh:
    """The JAX package's ``("data", "model")`` mesh as the island runs
    it: ``ctx``'s kernels are the model axis, ``data`` groups of the
    batch the data axis."""

    ctx: ShoalContext
    data: int = 1


def init_moe(gen: torch.Generator, d: int, dims: MoEDims, lead: tuple = (),
             dtype: torch.dtype = torch.float32):
    """Float32 draws, each cast to ``dtype`` as soon as it is drawn (a
    full-width expert stack is 2.7 GB a layer in float32); ``lead`` is
    the segment's layer axis."""
    n = len(lead)
    E, fe = dims.n_experts, dims.d_ff_expert

    def draw(shape, in_axis=0):
        return bl.dense_init(gen, lead + shape, n + in_axis).to(dtype)

    p = {"router": draw((d, E)),
         "wg": draw((E, d, fe), 1),
         "wu": draw((E, d, fe), 1),
         "wd": draw((E, fe, d), 1)}
    if dims.n_shared:
        fs = fe * dims.n_shared
        p["ws_g"] = draw((d, fs))
        p["ws_u"] = draw((d, fs))
        p["ws_d"] = draw((fs, d))
    return p


def _route(router_w, x, dims: MoEDims):
    """Top-k gating. x: (T, d) -> (gates (T, k), experts (T, k), aux).

    A stable descending sort picks the top k, so equal probabilities go
    to the lower expert index first, as ``lax.top_k`` orders them."""
    logits = (x @ router_w.to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = top.values[:, :dims.top_k]
    experts = top.indices[:, :dims.top_k]
    if dims.router_norm:
        gates = gates / torch.sum(gates, dim=-1, keepdim=True)
    # Switch-style load-balance auxiliary loss
    T = x.shape[0]
    me = torch.mean(probs, dim=0)
    ce = torch.bincount(experts.reshape(-1), minlength=dims.n_experts)
    ce = ce.float() / (T * dims.top_k)
    aux = dims.n_experts * torch.sum(me * ce)
    return gates.to(x.dtype), experts, aux


def _expert_compute(p, x_e):
    """x_e: (E_local, C, d) -> (E_local, C, d) via per-expert SwiGLU."""
    g = F.silu(torch.bmm(x_e, p["wg"].to(x_e.dtype)))
    u = torch.bmm(x_e, p["wu"].to(x_e.dtype))
    return torch.bmm(g * u, p["wd"].to(x_e.dtype))


def _ranks(keys, n_buckets: int):
    """Each entry's rank among the entries of its bucket, in entry order
    (a stable sort, first index by ``searchsorted`` on the left)."""
    order = torch.sort(keys, stable=True).indices
    sorted_k = keys[order]
    first = torch.searchsorted(
        sorted_k, torch.arange(n_buckets, device=keys.device))
    rank_sorted = torch.arange(keys.numel(), device=keys.device) \
        - first[sorted_k]
    return torch.empty_like(rank_sorted).scatter_(0, order, rank_sorted)


def _fill(n_slots: int, slot, ok, rows):
    """``(n_slots + 1, ...)`` zeros with ``rows`` where ``ok`` written at
    ``slot``; every pair not ``ok`` lands on the last (discarded) row."""
    mask = ok.reshape(ok.shape + (1,) * (rows.dim() - 1))
    buf = rows.new_zeros((n_slots + 1,) + rows.shape[1:])
    return buf.index_put((slot,), torch.where(mask, rows, 0))


def _combine(contrib, T: int, k: int):
    """Sum each token's k contributions ``(T * k, d)`` in order, rounding
    to their dtype after each add, as the JAX package's scatter-add of
    ``repeat(arange(T), k)`` does (an atomic ``index_add_`` would add
    them in any order)."""
    c = contrib.reshape(T, k, -1)
    out = c.new_zeros((T, c.shape[-1]))
    for j in range(k):
        out = out + c[:, j]
    return out


def shared_experts(p, x, *, unread: bool = False):
    """The shared experts (deepseek-v2) of x (..., d): one dense SwiGLU
    every token passes through, added to the routed experts' output
    (inside :func:`moe_ffn`, outside the island).  ``unread``: their
    down projection ends a checkpoint region (``blocks.product``)."""
    d = x.shape[-1]
    return bl.swiglu(x.reshape(-1, d), p["ws_g"], p["ws_u"],
                     p["ws_d"], unread=unread).reshape(x.shape)


def moe_ffn(p, x, dims: MoEDims, *, unread: bool = False):
    """Single-device MoE feed-forward over x (B, S, d), the shared
    experts included: the oracle the island is held to.  ``unread``:
    the shared experts' down projection ends a checkpoint region."""
    B, S, d = x.shape
    T = B * S
    xf = x.reshape(T, d)
    E = dims.n_experts
    capacity = max(1, int(T * dims.top_k * dims.capacity_factor / E))
    out, aux = _dispatch_local(p, xf, dims, 0, E, capacity)
    if dims.n_shared:
        out = out + shared_experts(p, xf, unread=unread)
    return out.reshape(B, S, d), aux


def _dispatch_local(p_local, x, dims: MoEDims, e_lo: int, E_local: int,
                    capacity: int):
    """Sort-based dispatch for the ``E_local`` experts from ``e_lo``
    whose weights are ``p_local``.  Tokens routed elsewhere contribute
    zero here (combined by the caller)."""
    T, d = x.shape
    shard = e_lo // E_local
    with spans.span("moe.route", shard=shard):
        gates, experts, aux = _route(p_local["router"], x, dims)
    with spans.span("moe.experts", shard=shard):
        flat_e = experts.reshape(-1)
        flat_g = gates.reshape(-1)
        flat_tok = torch.arange(T, device=x.device).repeat_interleave(
            dims.top_k)

        rank = _ranks(flat_e, dims.n_experts)
        mine = (flat_e >= e_lo) & (flat_e < e_lo + E_local)
        local = mine & (rank < capacity)
        n_slots = E_local * capacity
        if spans.counting():
            _count_dispatch(T * dims.top_k if E_local == dims.n_experts
                            else mine.sum(), local.sum(), n_slots)
        slot = torch.where(local, (flat_e - e_lo) * capacity + rank, n_slots)
        x_slots = _fill(n_slots, slot, local, x[flat_tok])
        y_e = _expert_compute(p_local,
                              x_slots[:-1].reshape(E_local, capacity, d))
        y_slots = y_e.reshape(n_slots, d)
        contrib = torch.where(local[:, None],
                              y_slots[torch.clamp(slot, 0, n_slots - 1)], 0)
        return _combine(contrib * flat_g[:, None], T, dims.top_k), aux


def _count_dispatch(routed, kept, slots: int) -> None:
    """A dispatch's counters while :mod:`repro_torch.runtime.spans`
    records: the pairs routed to its slots, those kept (under the
    capacity), the slots it computes and the pairs it dropped.  The
    pair counts are host ints or one-element tensors, summed on the
    device."""
    spans.add("moe.routed_pairs", routed)
    spans.add("moe.kept_pairs", kept)
    spans.add("moe.slots", slots)
    spans.add("moe.dropped_pairs", routed - kept)


# --------------------------------------------------------------------------
# the a2a dispatch, one shard's three stages around the two exchanges
# --------------------------------------------------------------------------

def _a2a_send(router, x, dims: MoEDims, E_local: int, n_shards: int):
    """Route a shard's tokens and bucket every pair for its expert's
    owner: returns ``(send (n, C, d + 1), state for the combine, aux)``.
    Per-destination capacity ``C = ceil(T k cf / n)``; pairs past it are
    dropped.  The last lane carries ``expert + 1`` (0: empty), bitcast
    into the payload dtype."""
    T, d = x.shape
    k = dims.top_k
    gates, experts, aux = _route(router, x, dims)
    flat_e = experts.reshape(-1)
    flat_tok = torch.arange(T, device=x.device).repeat_interleave(k)
    dest = flat_e // E_local

    C = max(1, int(-(-T * k * dims.capacity_factor // n_shards)))
    rank = _ranks(dest, n_shards)
    ok = rank < C
    if spans.counting():
        _count_dispatch(T * k, ok.sum(), n_shards * C)
    slot = torch.where(ok, dest * C + rank, n_shards * C)
    send_x = _fill(n_shards * C, slot, ok, x[flat_tok])
    send_e = _fill(n_shards * C, slot, ok, (flat_e + 1).to(torch.int32))
    meta = pack_meta_lane(send_e[:-1], x.dtype)
    send = torch.cat([send_x[:-1], meta[:, None]], dim=1)
    return send.reshape(n_shards, C, d + 1), (gates.reshape(-1), ok, slot), aux


def _a2a_experts(p_local, r, shard: int, E_local: int):
    """The owner's second-stage dispatch of the received rows ``r (n, C,
    d + 1)`` onto its local experts' slots; returns the result rows
    ``(n, C, d)`` in the order they came."""
    n, C, d1 = r.shape
    d = d1 - 1
    r = r.reshape(n * C, d1)
    rx = r[:, :d]
    re = unpack_meta_lane(r[:, d].contiguous())
    valid = re > 0
    le = torch.clamp(re - 1 - shard * E_local, 0, E_local - 1)
    C2 = max(1, int(-(-n * C // E_local)))
    keys = torch.where(valid, le, E_local)
    rank2 = _ranks(keys, E_local + 1)
    ok2 = valid & (rank2 < C2)
    n_slots = E_local * C2
    slot2 = torch.where(ok2, le * C2 + rank2, n_slots)
    x_slots = _fill(n_slots, slot2, ok2, rx)
    y_e = _expert_compute(p_local, x_slots[:-1].reshape(E_local, C2, d))
    y_rows = torch.where(
        ok2[:, None],
        y_e.reshape(n_slots, d)[torch.clamp(slot2, 0, n_slots - 1)], 0)
    return y_rows.reshape(n, C, d)


def _a2a_combine(ry, state, k: int):
    """Results home ``ry (n, C, d)`` back onto their tokens."""
    flat_g, ok, slot = state
    n, C, d = ry.shape
    ry = ry.reshape(n * C, d)
    back = torch.where(ok[:, None], ry[torch.clamp(slot, 0, n * C - 1)], 0)
    return _combine(back * flat_g[:, None], ok.numel() // k, k)


# --------------------------------------------------------------------------
# the expert-parallel island
# --------------------------------------------------------------------------

def _slabs(ctx: ShoalContext, p, E_local: int, dtype):
    """Every kernel's experts, ``[{router, wg, wu, wd}, ...]``: the
    router broadcast to the kernels, each expert stack split into the
    kernels' slabs (views, one split a leaf, so autograd stacks the
    slabs' gradients once)."""
    router = coll.broadcast_to_kernels(ctx, p["router"]).to(dtype)
    parts = {name: p[name].split(E_local) for name in ROUTED[1:]}
    return [{"router": router[s],
             **{name: parts[name][s].to(dtype) for name in ROUTED[1:]}}
            for s in range(ctx.num_kernels)]


def _to_shards(ctx: ShoalContext, x, D: int, seq: bool):
    """``(B, S, d)`` -> every ``(kernel, data group)`` shard's tokens
    ``(K, D, T, d)``, each in ``(b, s)`` order: sequence-sharded over the
    kernels when ``seq``, else replicated (a broadcast whose cotangent
    is all-reduced over the kernels)."""
    K = ctx.num_kernels
    B, S, d = x.shape
    if B % D or (seq and S % K):
        raise ValueError(f"moe island: batch {B} x sequence {S} does not "
                         f"shard over {D} data groups x {K} kernels")
    x = x.reshape(D, B // D, S, d)
    if not seq:
        return coll.broadcast_to_kernels(ctx, x.reshape(D, (B // D) * S, d))
    x = x.reshape(D, B // D, K, S // K, d).permute(2, 0, 1, 3, 4)
    return x.reshape(K, D, (B // D) * (S // K), d)


def _from_shards(y, B: int, S: int, seq: bool):
    """Inverse of :func:`_to_shards` (a replicated result: kernel 0's)."""
    K, D, _, d = y.shape
    if not seq:
        return y[0].reshape(B, S, d)
    y = y.reshape(K, D, B // D, S // K, d).permute(1, 2, 0, 3, 4)
    return y.reshape(B, S, d)


def moe_routed_island(p, h, dims: MoEDims, mesh: ExpertMesh,
                      compute_dtype: torch.dtype):
    """Expert-parallel routed experts over ``mesh`` (the JAX package's
    ``moe_routed_island`` under its fully manual ``shard_map``).

    ``p``: the layer's MoE leaves (the routed ones are read; shared
    experts run outside).  ``h (B, S, d)`` crosses the island boundary
    in float32 and each shard computes in ``compute_dtype``; returns
    ``(out (B, S, d) in h.dtype, aux)``, ``aux`` the mean over every
    shard (one all-reduce).  Differentiable in ``h`` and the routed
    leaves (module docstring)."""
    ctx, D = mesh.ctx, mesh.data
    K, E, k = ctx.num_kernels, dims.n_experts, dims.top_k
    if E % K:
        raise ValueError(f"moe island: {E} experts do not split over {K} "
                         "kernels")
    E_local = E // K
    B, S, d = h.shape
    seq = dims.dispatch in ("a2a", "rs")
    x = _to_shards(ctx, h.float(), D, seq).to(compute_dtype)
    slabs = _slabs(ctx, p, E_local, compute_dtype)
    shards = [(s, g) for s in range(K) for g in range(D)]

    def stack(rows):                      # [K * D] -> (K, D, ...)
        return torch.stack(rows).reshape((K, D) + rows[0].shape)

    if dims.dispatch == "a2a":
        sent = []
        for s, g in shards:
            with spans.span("moe.route", shard=s):
                sent.append(_a2a_send(slabs[s]["router"], x[s, g], dims,
                                      E_local, K))
        auxs = [a for _, _, a in sent]
        send = stack([b for b, _, _ in sent])          # (K, D, n, C, d + 1)
        # one exchange carries every data group: block j of every group
        # goes to kernel j
        r = coll.all_to_all_vectored(
            ctx, send.transpose(1, 2).reshape(K, K, -1), tiled=False)
        r = r.reshape((K, K, D) + send.shape[3:]).transpose(1, 2)
        ys = []
        for s, g in shards:
            with spans.span("moe.experts", shard=s):
                ys.append(_a2a_experts(slabs[s], r[s, g], s, E_local))
        y = stack(ys)                                  # (K, D, n, C, d)
        with spans.span("moe.combine"):
            ry = coll.all_to_all_vectored(
                ctx, y.transpose(1, 2).reshape(K, K, -1), tiled=False)
            ry = ry.reshape((K, K, D) + y.shape[3:]).transpose(1, 2)
            out = stack([_a2a_combine(ry[s, g], sent[i][1], k).float()
                         for i, (s, g) in enumerate(shards)])
    elif dims.dispatch == "rs":
        Tl = x.shape[2]
        full = coll.ring_all_gather(ctx, x)            # (K, n, D Tl d)
        full = full.reshape(K, K, D, Tl, d).transpose(1, 2).reshape(
            K, D, K * Tl, d)
        capacity = max(1, int(K * Tl * k * dims.capacity_factor / E))
        ran = [_dispatch_local(slabs[s], full[s, g], dims, s * E_local,
                               E_local, capacity) for s, g in shards]
        auxs = [a for _, a in ran]
        part = stack([o.float() for o, _ in ran])      # (K, D, K Tl, d)
        # kernel j's reduced chunk is token block j of every data group
        part = part.reshape(K, D, K, Tl, d).transpose(1, 2)
        with spans.span("moe.combine"):
            out = coll.ring_reduce_scatter(ctx, part).reshape(K, D, Tl, d)
    elif dims.dispatch == "psum":
        T = x.shape[2]
        capacity = max(1, int(T * k * dims.capacity_factor / E))
        ran = [_dispatch_local(slabs[s], x[s, g], dims, s * E_local,
                               E_local, capacity) for s, g in shards]
        auxs = [a for _, a in ran]
        with spans.span("moe.combine"):
            out = coll.ring_all_reduce(ctx, stack([o.float()
                                                   for o, _ in ran]))
    else:
        raise ValueError(f"unknown MoE dispatch {dims.dispatch!r}")
    aux = coll.ring_all_reduce(ctx, stack(auxs))[0].sum() / (K * D)
    return _from_shards(out, B, S, seq).to(h.dtype), aux
