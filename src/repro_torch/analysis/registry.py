"""Registry of lintable entry points -- the programs the port's lint
guards, and the probes that must raise each rule.

Each entry builds (lazily; the imports are heavy) one representative
program of a subsystem on a device and returns ``(ctx, fn, args)``:
the Shoal context whose ``exchanges`` the budget reads, and the
callable :func:`repro_torch.analysis.lint.record_run` runs once under a
recorder.  The entries are the JAX package's registry at its sizes.
``moe-dispatch`` runs no Shoal op (0 events): its budget reads the
context's collective calls, which the MoE island makes on the
collectives layer.  :func:`run_entry` is
the one path the CLI (``scripts/torch_comm_lint.py``), the tests and
``chip_smoke.py`` share, so "zero findings on shipped entry points"
means the same thing everywhere.

:data:`MICROS` are the single-op programs of ``comm_budgets.toml``'s
nine ``[micro.*]`` sections (:func:`check_micro` holds each to its
section); :data:`PROBES` are small programs with known findings (rules R1-R4,
each with its clean counterpart, and the waived aliasing packets), the
port's copies of the JAX package's lint checks.

Entries run on the CUDA card unless ``device="cpu"`` is given.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.analysis import budget as _budget
from repro_torch.analysis import trace
from repro_torch.analysis.lint import record_run, report_of
from repro_torch.analysis.report import Report
from repro_torch.core.ops import VectoredAliasError

K = 8
RING = [(i, (i + 1) % K) for i in range(K)]


@dataclasses.dataclass(frozen=True)
class Entry:
    name: str
    description: str
    devices: int                  # kernels on the program's kernel axis
    build: Callable[[torch.device], tuple]   # -> (ctx, fn, args)


@dataclasses.dataclass
class EntryRun:
    """One recorded run of an entry: its events, the exchanges by scope
    tag, the context's exchange and collective-call deltas, what the
    program returned, and the report (rules, then the budget)."""

    name: str
    events: list
    tags: dict
    exchanges: int
    collectives: dict
    result: object
    report: Report


def _tiny_tcp():
    from repro_torch.runtime import TCP

    return dataclasses.replace(TCP, max_packet_bytes=64)


def _jacobi(device, iters: int):
    from repro_torch.apps.jacobi import JacobiApp
    from repro_torch.core.address_space import GlobalAddressSpace

    app = JacobiApp(n=64, kernels=K, iters=iters, transport=_tiny_tcp(),
                    device=device)
    st = GlobalAddressSpace(app.ctx).make_global_state()
    grid = np.random.default_rng(0).standard_normal((K, 64 // K, 64))
    blocks = torch.from_numpy(grid.astype(np.float32)).to(device)
    return app.ctx, app.run_blocks, (st, blocks)


def _build_jacobi(device):
    """Jacobi halo exchange, 64x64 on 8 kernels, segmenting halos."""
    return _jacobi(device, iters=1)


def _build_jacobi_steady(device):
    """Jacobi steady state: 4 piggybacked iterations, every one recorded.

    2 exchanges per iteration (one per halo direction, no ack
    exchanges -- acks ride the next iteration's reverse-link packet)
    plus the 2 loop-exit ledger drains.
    """
    return _jacobi(device, iters=4)


def _build_actors_mailbox(device):
    """The actor-layer headline: 1024 4-word sends -> one flush."""
    from repro_torch.core import ops
    from repro_torch.core.address_space import GlobalAddressSpace
    from repro_torch.core.state import ShoalContext
    from repro_torch.runtime import TCP

    n_msgs, w = 1024, 4
    ctx = ShoalContext(K, TCP, n_msgs * w + 64, device=device)

    def prog(st):
        mb = ctx.mailbox(RING, msg_words=w, watermark=1 << 20, token=1)
        base = np.arange(w, dtype=np.float32)
        for i in range(n_msgs):
            st = mb.send(st, base + i, dst_addr=w * i)
        st = mb.flush(st)
        return ops.wait_replies(ctx, st, token=1, n=1)

    return ctx, prog, (GlobalAddressSpace(ctx).make_global_state(),)


def _build_lossy_put(device):
    """Reliable put over a 1%-drop link: a 4-segment acked put + wait.

    1 + max_retries rounds all run, each a data exchange plus an ack
    exchange -- 2 * (1 + max_retries) exchanges -- but rounds after
    delivery ship all-NOP packets, so the *dynamic* cost is the
    ``retransmits`` state counter, not the exchange count.
    """
    from repro_torch.core import ops
    from repro_torch.core.address_space import GlobalAddressSpace
    from repro_torch.core.faults import FaultModel
    from repro_torch.core.state import ShoalContext
    from repro_torch.runtime import LossyTransport

    transport = LossyTransport(faults=FaultModel(drop=0.01, seed=7),
                               max_packet_bytes=16, max_retries=4)
    ctx = ShoalContext(K, transport, 64, device=device)

    def prog(st):
        me = ctx.my_id()[:, None].to(torch.float32)
        pay = (torch.arange(16, dtype=torch.float32, device=ctx.device)
               + 1) * (me + 1)
        st = ops.put_long(ctx, st, pay, RING, dst_addr=10, token=1)
        return ops.wait_replies(ctx, st, token=1, n=1)

    return ctx, prog, (GlobalAddressSpace(ctx).make_global_state(),)


def build_kv_migrate(device, params=None):
    """Disaggregated-serving KV migration (one vectored put + reply):
    a 2-layer d32 float32 dense model on 2 prefill + 2 decode kernels,
    prefill kernel 0's fresh lane cache into decode kernel 2's lane 0.
    ``params`` (the model's parameters on ``device``) default to a
    seeded init; the migrated blocks do not depend on them."""
    from repro_torch.launch.mesh import ServingSlices
    from repro_torch.models.model import ModelConfig, build_model
    from repro_torch.serving.disagg import DisaggServeTier
    from repro_torch.serving.engine import lane_slice
    from repro_torch.serving.kv_space import MIGRATE_TOKEN

    cfg = ModelConfig(name="lint-kv", family="dense", n_layers=2, d_model=32,
                      n_heads=2, n_kv_heads=2, d_ff=64, vocab=64,
                      dtype=torch.float32)
    model = build_model(cfg, device=device)
    if params is None:
        params = model.init(torch.Generator(device=device).manual_seed(0))
    tier = DisaggServeTier(model, params,
                           ServingSlices(n_prefill=2, n_decode=2),
                           lanes_per_decode=2, slots=16, device=device)
    blocks = tier.kv.pack_lane(lane_slice(tier.workers[0].cache, 0))
    pattern = tier.slices.migration_pattern(0, 2)

    def migration(st, blocks):
        return tier.kv.migrate(st, blocks, pattern, 0, token=MIGRATE_TOKEN)

    return tier.ctx, migration, (tier.state, blocks)


def build_moe_dispatch(device, params=None):
    """MoE all-to-all expert dispatch: 2 MoE layers (d 64, 4 heads, 8
    experts top-2, one shared expert, capacity factor 16) whose routed
    experts run as the a2a island over 4 kernels x 2 data groups (the
    JAX entry's mesh (2, 4)), ``Model.loss`` forward on (4, 32) seeded
    tokens: 2 all-to-alls a layer and one all-reduce of its aux.
    ``params`` default to a seeded init drawn on the CPU (the same
    weights on every device)."""
    from repro_torch.core.state import ShoalContext
    from repro_torch.models.model import (ModelConfig, build_model,
                                          cast_params)
    from repro_torch.models.moe import ExpertMesh, MoEDims

    dims = MoEDims(n_experts=8, top_k=2, d_ff_expert=64, n_shared=1,
                   capacity_factor=16.0, dispatch="a2a")
    cfg = ModelConfig(name="lint-moe", family="moe", n_layers=2, d_model=64,
                      n_heads=4, n_kv_heads=4, d_ff=128, vocab=128,
                      seq_shard=True, aux_loss_weight=0.0, moe=dims,
                      dtype=torch.float32)
    ctx = ShoalContext(4, device=device)
    model = build_model(cfg, device=device, ep=ExpertMesh(ctx, data=2))
    if params is None:
        params = cast_params(cfg, build_model(cfg, device="cpu").init(
            torch.Generator().manual_seed(1)), device)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, 128, (4, 32))).to(device)
    batch = {"tokens": toks, "labels": toks}
    return ctx, model.loss, (params, batch)


ENTRIES: tuple[Entry, ...] = (
    Entry("jacobi", "Jacobi halo exchange (64x64, 8 kernels, 16-word MTU)",
          8, _build_jacobi),
    Entry("jacobi-steady",
          "Jacobi steady state: 4 piggybacked iterations, 2 exchanges/iter",
          8, _build_jacobi_steady),
    Entry("actors-mailbox", "1024 4-word mailbox sends, one flush + wait",
          8, _build_actors_mailbox),
    Entry("kv-migrate", "serving KV migration, prefill 0 -> decode 2",
          4, build_kv_migrate),
    Entry("lossy-put",
          "reliable 4-seg put over 1%-drop DCN, retransmit + dedup",
          8, _build_lossy_put),
    Entry("moe-dispatch", "MoE a2a expert dispatch, 2 layers, (2, 4) "
          "data x kernels, forward loss", 4, build_moe_dispatch),
)


def names() -> list[str]:
    return [e.name for e in ENTRIES]


def get(name: str) -> Entry:
    for e in ENTRIES:
        if e.name == name:
            return e
    raise KeyError(f"unknown lint entry {name!r}; known: {names()}")


def run_program(name: str, build: Callable, device=None) -> EntryRun:
    """Build one program on ``device`` (default: the card), run it once
    under a recorder and lint its schedule (rules R1-R5)."""
    from repro_torch.core.state import resolve_device

    device = resolve_device(device)
    ctx, fn, args = build(device)
    before, calls = ctx.exchanges, dict(ctx.collectives)
    result, rec = record_run(fn, *args)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return EntryRun(name=name, events=rec.events,
                    tags=trace.recover_tags(rec),
                    exchanges=ctx.exchanges - before,
                    collectives={k: n - calls[k]
                                 for k, n in ctx.collectives.items()},
                    result=result, report=report_of(rec, name))


def lint_entry(name: str, budgets: dict | None = None, *,
               include_budget: bool = True, device=None) -> EntryRun:
    """Run one registered entry point: its rules, then (unless
    ``include_budget`` is false) its exchanges and collective calls
    against ``comm_budgets.toml`` (or ``budgets``)."""
    t0 = time.perf_counter()
    run = run_program(name, get(name).build, device)
    rep = run.report
    if include_budget:
        spec = (_budget.load_budgets() if budgets is None
                else budgets).get(name)
        measured = _budget.measure(run.exchanges, run.collectives)
        rep.extend(_budget.check_budget(name, measured, spec, run.tags))
        rep.budget = _budget.budget_row(measured, spec, run.tags)
    rep.wall_time_s = time.perf_counter() - t0
    return run


def run_entry(name: str, budgets: dict | None = None, *,
              include_budget: bool = True, device=None) -> Report:
    """The report of one registered entry point (see :func:`lint_entry`),
    run on ``device`` (default: the CUDA card)."""
    return lint_entry(name, budgets, include_budget=include_budget,
                      device=device).report


# --------------------------------------------------------------------------
# micro budgets: single ops on a 64-byte MTU
# --------------------------------------------------------------------------

MICRO_SEGMENT_WORDS = 128
EVEN = [(i, i + 1) for i in range(0, K, 2)]      # two disjoint rings:
ODD = [(i, (i + 1) % K) for i in range(1, K, 2)]  # sources AND dests


def _micro(prog, acked: bool = True, dtype=torch.float32):
    """A micro builder from ``prog(ops, ctx, st)`` over 8 kernels, a
    64-byte (16-word) MTU, TCP (``acked``) or UDP, 128-word segments of
    ``dtype``."""
    def build(device):
        from repro_torch.core import ops
        from repro_torch.core.address_space import GlobalAddressSpace
        from repro_torch.core.state import ShoalContext
        from repro_torch.runtime import TCP, UDP

        transport = dataclasses.replace(TCP if acked else UDP,
                                        max_packet_bytes=64)
        ctx = ShoalContext(K, transport, MICRO_SEGMENT_WORDS, device=device)
        st = GlobalAddressSpace(ctx, dtype=dtype).make_global_state()
        return ctx, (lambda st: prog(ops, ctx, st)), (st,)
    return build


def _put_4seg(asynchronous):
    def prog(ops, ctx, st):          # 50 words: 4 packets of <= 16
        st = ops.put_long(ctx, st, _pay(ctx, 50), RING, dst_addr=8,
                          token=1, asynchronous=asynchronous)
        return st if asynchronous else ops.wait_replies(ctx, st, token=1,
                                                        n=1)
    return prog


def _get_4seg(ops, ctx, st):
    st, _ = ops.get_medium(ctx, st, RING, src_addr=0, nwords=50, token=2)
    return ops.wait_replies(ctx, st, token=2, n=1)


def _vectored_2(ops, ctx, st):
    ones = torch.ones(K, 5, device=ctx.device)
    return ops.put_long_vectored(ctx, st, [ones[:, :2], ones[:, 2:]], RING,
                                 dst_addrs=[40, 60], token=3)


def _multi(defer_ack):
    def prog(ops, ctx, st):
        items = [(_pay(ctx, 50), EVEN, 8),
                 (torch.ones(K, 34, device=ctx.device), ODD, 64)]
        st = ops.put_long_multi(ctx, st, items, token=4, defer_ack=defer_ack)
        # deferred: the receivers ledger the acks; a later reverse-link
        # packet (or a drain) carries them home -- nothing more here
        return st if defer_ack else ops.wait_replies(ctx, st, token=4, n=1)
    return prog


def _put_bf16(ops, ctx, st):
    pay = torch.ones(K, 10, dtype=torch.bfloat16, device=ctx.device)
    st = ops.put_long(ctx, st, pay, RING, dst_addr=8, token=1)
    return ops.wait_replies(ctx, st, token=1, n=1)


def _multi_mailbox(ops, ctx, st):
    from repro_torch.actors import MultiMailbox

    mmb = MultiMailbox(ctx, [EVEN, ODD], msg_words=4, watermark=1 << 20,
                       token=6)
    base = np.arange(4, dtype=np.float32)
    for i in range(6):
        st = mmb.send(st, i % 2, base + i, dst_addr=4 * i)
    st = mmb.flush(st)
    return ops.wait_replies(ctx, st, token=6, n=1)


def _build_jacobi_iter(device):
    """One Jacobi iteration, n 64 on 8 kernels, 16-word MTU: each 64-word
    halo row is 4 packets; the two halo messages and the two ack drains
    are 4 exchanges."""
    from repro_torch.apps.jacobi import JacobiApp
    from repro_torch.core.address_space import GlobalAddressSpace

    app = JacobiApp(n=64, kernels=K, iters=1, transport=_tiny_tcp(),
                    device=device)
    st = GlobalAddressSpace(app.ctx).make_global_state()
    blocks = torch.zeros(K, 64 // K, 64, device=device)
    return app.ctx, app.run_blocks, (st, blocks)


# the nine [micro.*] sections of comm_budgets.toml, the programs of the
# JAX package's tests/hlo_budget_checks.py
MICROS: tuple[Entry, ...] = (
    Entry("micro.put_long_acked_4seg", "acked 50-word put: one 4-segment "
          "stack + one ack", K, _micro(_put_4seg(False))),
    Entry("micro.put_long_async_4seg", "the same put on UDP: no ack", K,
          _micro(_put_4seg(True), acked=False)),
    Entry("micro.get_medium_4seg", "50-word get: request + 4-segment "
          "response", K, _micro(_get_4seg)),
    Entry("micro.put_long_vectored", "2 blocks in one packet + one ack", K,
          _micro(_vectored_2)),
    Entry("micro.jacobi_iter_segmenting", "one Jacobi iteration, segmenting "
          "halos + 2 ack drains", K, _build_jacobi_iter),
    Entry("micro.put_long_multi_merged", "2 disjoint rings: one stack + one "
          "reply", K, _micro(_multi(False))),
    Entry("micro.put_long_multi_deferred", "the same with defer_ack: the "
          "stack alone", K, _micro(_multi(True))),
    Entry("micro.put_long_bf16_fallback", "acked bf16 put: split header / "
          "payload + one ack", K, _micro(_put_bf16, dtype=torch.bfloat16)),
    Entry("micro.multi_mailbox_flush", "MultiMailbox over 2 disjoint rings: "
          "one stack + one reply", K, _micro(_multi_mailbox)),
)


def check_micro(name: str, budgets: dict | None = None,
                device=None) -> tuple[EntryRun, list]:
    """One ``[micro.*]`` program run once on ``device`` (default: the
    card) and held to its section of ``comm_budgets.toml`` (or
    ``budgets``) through :func:`budget.check_budget`.  Returns the run
    and the budget's (B1) findings; the run's report carries only the
    rules, which these single-op programs need not satisfy (a vectored
    put no one waits for, ledgered acks no drain returns)."""
    micro = next((m for m in MICROS if m.name == name), None)
    if micro is None:
        raise KeyError(f"unknown micro program {name!r}; known: "
                       f"{[m.name for m in MICROS]}")
    run = run_program(name, micro.build, device)
    spec = (_budget.load_budgets() if budgets is None else budgets).get(name)
    measured = _budget.measure(run.exchanges, run.collectives)
    return run, _budget.check_budget(name, measured, spec, run.tags)


# --------------------------------------------------------------------------
# probes: programs with known findings
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Probe:
    name: str
    description: str
    build: Callable[[torch.device], tuple]   # -> (ctx, fn, args)
    expect: tuple[str, ...] = ()     # unwaived findings' rules, in order
    waived: tuple[str, ...] = ()     # waived findings' rules, in order
    raises: type | None = None       # the call raises this instead


def _probe_ctx(device, segment_words: int = 128):
    from repro_torch.core.address_space import GlobalAddressSpace
    from repro_torch.core.state import ShoalContext
    from repro_torch.runtime import TCP

    ctx = ShoalContext(K, TCP, segment_words, device=device)
    return ctx, GlobalAddressSpace(ctx).make_global_state()


def _pay(ctx, words: int, first: float = 0.0):
    """``first + arange(words)`` on every kernel, ``(K, words)``."""
    row = torch.arange(words, dtype=torch.float32, device=ctx.device) + first
    return row.expand(ctx.num_kernels, -1).contiguous()


def _probe(prog):
    """A probe builder from ``prog(ops, ctx, st)``."""
    def build(device):
        from repro_torch.core import ops

        ctx, st = _probe_ctx(device)
        return ctx, (lambda st: prog(ops, ctx, st)), (st,)
    return build


def _strided(overlap):
    def prog(ops, ctx, st):
        st = ops.put_long_strided(ctx, st, _pay(ctx, 16), RING, dst_addr=0,
                                  stride=2, blk_words=4, nblocks=4,
                                  overlap=overlap, token=1)
        return ops.wait_replies(ctx, st, token=1, n=1)
    return prog


def _pair(first, second, waited):
    """Two 8-word puts at ``first`` and ``second``, a wait on the first
    put's token between them if ``waited``."""
    def prog(ops, ctx, st):
        st = ops.put_long(ctx, st, _pay(ctx, 8), RING, dst_addr=first,
                          token=1)
        if waited:
            st = ops.wait_replies(ctx, st, token=1, n=1)
        st = ops.put_long(ctx, st, _pay(ctx, 8, 1.0), RING, dst_addr=second,
                          token=2)
        if not waited:
            st = ops.wait_replies(ctx, st, token=1, n=1)
        return ops.wait_replies(ctx, st, token=2, n=1)
    return prog


def _get(waited):
    def prog(ops, ctx, st):
        st = ops.put_long(ctx, st, _pay(ctx, 8), RING, dst_addr=4, token=1)
        if waited:
            st = ops.wait_replies(ctx, st, token=1, n=1)
        st, _ = ops.get_medium(ctx, st, RING, src_addr=6, nwords=4, token=2)
        st = ops.wait_replies(ctx, st, token=2, n=1)
        if not waited:
            st = ops.wait_replies(ctx, st, token=1, n=1)
        return st
    return prog


def _underflow(ops, ctx, st):
    st = ops.put_long(ctx, st, _pay(ctx, 4), RING, dst_addr=0, token=1)
    return ops.wait_replies(ctx, st, token=1, n=2)


def _leak(ops, ctx, st):
    return ops.put_long(ctx, st, _pay(ctx, 4), RING, dst_addr=0, token=1)


def _double_spend(ops, ctx, st):
    a = ctx.mailbox(RING, msg_words=4, token=3)
    b = ctx.mailbox(RING, msg_words=4, token=3)
    st = a.send(st, np.arange(4, dtype=np.float32), dst_addr=0)
    st = a.flush(st)
    st = b.send(st, np.arange(4, dtype=np.float32), dst_addr=16)
    st = b.flush(st)
    return ops.wait_replies(ctx, st, token=3, n=2)


def _oob(ops, ctx, st):
    st = ops.put_long(ctx, st, _pay(ctx, 50), RING, dst_addr=100, token=1)
    return ops.wait_replies(ctx, st, token=1, n=1)


def _vectored_alias(addrs, waived):
    """An asynchronous vectored put of 4-word blocks at ``addrs``, block
    ``i`` holding ``10 * (i + 1) + arange(4)`` (so the landed order is
    visible), under a waiver if ``waived``."""
    def prog(ops, ctx, st):
        blocks = [_pay(ctx, 4, 10.0 * (i + 1)) for i in range(len(addrs))]
        with (trace.waiver("last-writer-wins is intended here") if waived
              else contextlib.nullcontext()):
            return ops.put_long_vectored(ctx, st, blocks, RING,
                                         dst_addrs=list(addrs), token=1,
                                         asynchronous=True)
    return prog


def _multi_alias(ops, ctx, st):
    """A waived put_long_multi whose two items land on the same kernel
    at overlapping intervals ([8, 16) and [12, 20)); item 1 wins."""
    back = [(d, s) for s, d in RING]
    items = [(_pay(ctx, 8, 10.0), RING, 8), (_pay(ctx, 8, 20.0), back, 12)]
    with trace.waiver("the second item overwrites on purpose"):
        st = ops.put_long_multi(ctx, st, items, tokens=[1, 2])
    st = ops.wait_replies(ctx, st, token=1, n=1)
    return ops.wait_replies(ctx, st, token=2, n=1)


PROBES: tuple[Probe, ...] = (
    Probe("strided-prefix-race", "aliasing strided put on the unordered "
          "ingress (overlap=False)", _probe(_strided(False)), ("R1",)),
    Probe("strided-ordered", "the same put on the ordered ingress",
          _probe(_strided(None))),
    Probe("overlap-pair", "two overlapping puts, no wait between",
          _probe(_pair(4, 8, False)), ("R1",)),
    Probe("overlap-pair-waited", "the same puts, a wait between",
          _probe(_pair(4, 8, True))),
    Probe("disjoint-pair", "two disjoint puts",
          _probe(_pair(0, 16, False))),
    Probe("get-inflight", "a get of a range with a put in flight",
          _probe(_get(False)), ("R2",)),
    Probe("get-after-wait", "the get after the put's wait",
          _probe(_get(True))),
    Probe("underflow", "wait for 2 replies of 1 put", _probe(_underflow),
          ("R3",)),
    Probe("leak", "an acked put never waited for", _probe(_leak), ("R3",)),
    Probe("double-spend", "two mailboxes flushing acks on one token",
          _probe(_double_spend), ("R3",)),
    Probe("oob", "a 50-word put at 100 of a 128-word segment",
          _probe(_oob), ("R4",)),
    Probe("vectored-alias", "vectored blocks at [8, 12) and [10, 14)",
          _probe(_vectored_alias((8, 10), False)),
          raises=VectoredAliasError),
    Probe("vectored-alias-waived", "the same packet under a waiver",
          _probe(_vectored_alias((8, 10), True)), waived=("R4",)),
    Probe("vectored-alias-waived-4", "4 blocks, the first two aliasing, "
          "under a waiver (the Hopper scatter's shared-word path)",
          _probe(_vectored_alias((8, 10, 16, 24), True)), waived=("R4",)),
    Probe("multi-alias-waived", "a batched put of two aliasing items under "
          "a waiver (the rules' pair check, R1)", _probe(_multi_alias),
          waived=("R1",)),
)


def get_probe(name: str) -> Probe:
    for p in PROBES:
        if p.name == name:
            return p
    raise KeyError(f"unknown probe {name!r}")


def run_probe(name: str, device=None) -> EntryRun:
    """One probe's recorded run on ``device`` (default: the card)."""
    return run_program(name, get_probe(name).build, device)
