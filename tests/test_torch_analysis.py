"""The port's shoal-lint (``repro_torch.analysis``) against the JAX
package's (``repro.analysis``).

* Rules parity, fuzzed: the schedules of ``tests/test_comm_lint.py``
  (puts, defer_ack puts, two-stack ``put_long_multi`` calls, piggyback
  and drain grants, waits, barriers) plus lossy puts, timeout waits,
  Short grants, mailbox flushes, per-kernel (unknown) operands and
  waivers go, converted field for field, through both packages'
  ``analyze``: the findings must be equal (rule, severity, events,
  sites, waiver, message).  The port's R1 and R3 verdicts must equal
  ``tests/actor_checks.py``'s ``sequential_schedule_oracle``.
* Op-level parity: the JAX package lints the R1-R4 programs of
  ``tests/comm_lint_checks.py`` (and the waived aliasing packets) and
  the registry entries ``jacobi``, ``jacobi-steady``, ``actors-mailbox``
  and ``kv-migrate`` in one 8-device subprocess (``python
  tests/test_torch_analysis.py OUT.npz``, no compile for the lint); the
  port's CPU run of the same programs must give the same findings and,
  event for event, the same op, pattern, intervals, token and flags.
  The JAX package records one instance of ``jacobi-steady``'s
  ``lax.scan`` body and the port records every iteration: the port's
  events there are the reference's iteration events repeated ``iters``
  times, then the drains.  The waived packets and the migration also
  run, and land the same words on both sides (tolerance: none).
* Budgets (the collective kinds measured from ``ctx.collectives``,
  ``wire_bytes`` a not-measured warning), ``moe-dispatch`` (the MoE
  a2a island: no Shoal event, 4 all-to-alls, the JAX entry's count in
  ``BENCH_comm.json``; a broken budget a B1 error), ``lossy-put``, the
  cost of the hooks, the CLI.
"""

import dataclasses
import importlib.util
import json
import os
import random
import sys

import numpy as np
import pytest
import torch

from repro_torch.analysis.lint import events_json

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_reference import N, REPO, run_reference  # noqa: E402

RING = [(i, (i + 1) % N) for i in range(N)]
STEADY_ITERS = 4
ENTRIES = ("jacobi", "jacobi-steady", "actors-mailbox", "kv-migrate")
WAIVED_RUNS = ("vectored-alias-waived", "vectored-alias-waived-4",
               "multi-alias-waived")
WAIVER = "last-writer-wins is intended here"


def _findings_json(findings):
    return [[f.rule, f.severity, list(f.events), list(f.sites), f.waived,
             f.message] for f in findings]


# --------------------------------------------------------------------------
# the JAX package's side (runs in the subprocess)
# --------------------------------------------------------------------------

def _reference_programs(ops, analysis, ctx, jnp):
    """The R1-R4 programs of tests/comm_lint_checks.py (and the waived
    aliasing packets), by the port's probe names."""
    pay16 = jnp.arange(16, dtype=jnp.float32)
    pay8 = jnp.arange(8, dtype=jnp.float32)
    pay4 = jnp.arange(4, dtype=jnp.float32)

    def strided(overlap):
        def prog(st):
            st = ops.put_long_strided(ctx, st, pay16, RING, dst_addr=0,
                                      stride=2, blk_words=4, nblocks=4,
                                      overlap=overlap, token=1)
            return ops.wait_replies(ctx, st, token=1, n=1)
        return prog

    def pair(first, second, waited):
        def prog(st):
            st = ops.put_long(ctx, st, pay8, RING, dst_addr=first, token=1)
            if waited:
                st = ops.wait_replies(ctx, st, token=1, n=1)
            st = ops.put_long(ctx, st, pay8 + 1, RING, dst_addr=second,
                              token=2)
            if not waited:
                st = ops.wait_replies(ctx, st, token=1, n=1)
            return ops.wait_replies(ctx, st, token=2, n=1)
        return prog

    def get(waited):
        def prog(st):
            st = ops.put_long(ctx, st, pay8, RING, dst_addr=4, token=1)
            if waited:
                st = ops.wait_replies(ctx, st, token=1, n=1)
            st, _ = ops.get_medium(ctx, st, RING, src_addr=6, nwords=4,
                                   token=2)
            st = ops.wait_replies(ctx, st, token=2, n=1)
            if not waited:
                st = ops.wait_replies(ctx, st, token=1, n=1)
            return st
        return prog

    def underflow(st):
        st = ops.put_long(ctx, st, pay4, RING, dst_addr=0, token=1)
        return ops.wait_replies(ctx, st, token=1, n=2)

    def leak(st):
        return ops.put_long(ctx, st, pay4, RING, dst_addr=0, token=1)

    def double_spend(st):
        a = ctx.mailbox(RING, msg_words=4, token=3)
        b = ctx.mailbox(RING, msg_words=4, token=3)
        st = a.send(st, pay4, dst_addr=0)
        st = a.flush(st)
        st = b.send(st, pay4, dst_addr=16)
        st = b.flush(st)
        return ops.wait_replies(ctx, st, token=3, n=2)

    def oob(st):
        st = ops.put_long(ctx, st, jnp.arange(50, dtype=jnp.float32), RING,
                          dst_addr=100, token=1)
        return ops.wait_replies(ctx, st, token=1, n=1)

    def vectored(addrs, waived):
        def prog(st):
            blocks = [jnp.arange(4, dtype=jnp.float32) + 10.0 * (i + 1)
                      for i in range(len(addrs))]

            def put(st):
                return ops.put_long_vectored(ctx, st, blocks, RING,
                                             dst_addrs=list(addrs), token=1,
                                             asynchronous=True)
            if not waived:
                return put(st)
            with analysis.waiver(WAIVER):
                return put(st)
        return prog

    def multi(st):
        back = [(d, s) for s, d in RING]
        items = [(jnp.arange(8, dtype=jnp.float32) + 10.0, RING, 8),
                 (jnp.arange(8, dtype=jnp.float32) + 20.0, back, 12)]
        with analysis.waiver("the second item overwrites on purpose"):
            st = ops.put_long_multi(ctx, st, items, tokens=[1, 2])
        st = ops.wait_replies(ctx, st, token=1, n=1)
        return ops.wait_replies(ctx, st, token=2, n=1)

    return {
        "strided-prefix-race": strided(False),
        "strided-ordered": strided(None),
        "overlap-pair": pair(4, 8, False),
        "overlap-pair-waited": pair(4, 8, True),
        "disjoint-pair": pair(0, 16, False),
        "get-inflight": get(False),
        "get-after-wait": get(True),
        "underflow": underflow,
        "leak": leak,
        "double-spend": double_spend,
        "oob": oob,
        "vectored-alias": vectored((8, 10), False),
        "vectored-alias-waived": vectored((8, 10), True),
        "vectored-alias-waived-4": vectored((8, 10, 16, 24), True),
        "multi-alias-waived": multi,
    }


def _reference_lint(fn, args):
    """``jaxpr_lint.lint`` with the recorded events kept."""
    import jax

    from repro.analysis import jaxpr_lint, rules, trace

    with trace.record() as rec:
        jax.make_jaxpr(jaxpr_lint._unwrap(fn))(*args)
    return rec.events, rules.analyze(rec.events)


def _run_reference(out_path):
    """Lints (and the waived packets' and the migration's landings) of
    the JAX package on 8 emulated devices; writes npz."""
    import jax
    import jax.numpy as jnp

    from repro import analysis
    from repro.analysis import registry
    from repro.core import ops
    from repro.core.address_space import GlobalAddressSpace
    from repro.core.state import ShoalContext
    from repro.runtime import TCP
    from repro.runtime.topology import make_cpu_mesh

    doc, arrays = {"probes": {}, "entries": {}}, {}
    ctx = ShoalContext(mesh=make_cpu_mesh(N, ("kernel",)), axes=("kernel",),
                       transport=TCP, segment_words=128)
    gas = GlobalAddressSpace(ctx)
    for name, prog in _reference_programs(ops, analysis, ctx, jnp).items():
        fn, st = gas.spmd(prog), gas.make_global_state()
        try:
            events, findings = _reference_lint(fn, (st,))
        except ops.VectoredAliasError as e:
            doc["probes"][name] = {"raises": type(e).__name__,
                                   "message": str(e)}
            continue
        doc["probes"][name] = {"events": events_json(events),
                               "findings": _findings_json(findings)}
        if name in WAIVED_RUNS:
            out = jax.jit(fn)(st)
            arrays[f"{name}/segment"] = np.asarray(out.segment)
            arrays[f"{name}/credits"] = np.asarray(out.credits)
    for name in ENTRIES:
        fn, args, _ = registry.get(name).build()
        events, findings = _reference_lint(fn, args)
        doc["entries"][name] = {"events": events_json(events),
                                "findings": _findings_json(findings)}
        if name == "kv-migrate":
            out = fn(*args)
            arrays["kv-migrate/segment"] = np.asarray(out.segment)
    # the kv-migrate entry's parameters (PRNGKey(0)), in pytree order
    from repro.models.model import ModelConfig, build_model

    cfg = ModelConfig(name="lint-kv", family="dense", n_layers=2, d_model=32,
                      n_heads=2, n_kv_heads=2, d_ff=64, vocab=64,
                      dtype=jnp.float32)
    params = build_model(cfg).init(jax.random.PRNGKey(0))
    for i, leaf in enumerate(jax.tree_util.tree_leaves(
            jax.device_get(params))):
        arrays[f"kv-params/{i}"] = np.asarray(leaf)
    arrays["doc"] = np.array(json.dumps(doc))
    np.savez(out_path, **arrays)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("analysis") / "reference.npz"
    out = run_reference(__file__, path, timeout=600)
    return json.loads(str(out.pop("doc"))), out


# --------------------------------------------------------------------------
# rules parity, fuzzed
# --------------------------------------------------------------------------

SEG = 16


def _extra_events(rng):
    """Events the fuzzed put/wait schedules lack: lossy puts (R5), timeout
    waits, Short grants, mailbox flushes, per-kernel operands."""
    from repro.analysis import CommEvent, Interval

    out = []
    for _ in range(rng.randint(1, 4)):
        r = rng.random()
        tok = rng.choice([0, 1, 2, None]) if rng.random() < 0.2 \
            else rng.randint(0, 2)
        words = rng.randint(1, 4)
        start = None if rng.random() < 0.15 else rng.randrange(0, SEG)
        if r < 0.35:
            acked = rng.random() < 0.7
            out.append(CommEvent(
                seq=0, op="put_long", pattern=((0, 1),),
                writes=(Interval(start, words),), token=tok, acked=acked,
                lossy=True, retries=rng.choice([0, 4]) if acked else 0,
                dedup=rng.random() < 0.6, segment_words=SEG))
        elif r < 0.5:
            out.append(CommEvent(seq=0, op="wait_replies", pattern=(),
                                 token=tok, wait_n=rng.choice([1, 2, None]),
                                 timeout=rng.random() < 0.5))
        elif r < 0.65:
            out.append(CommEvent(
                seq=0, op="put_short", pattern=((1, 0),), token=tok,
                acked=rng.random() < 0.5,
                credit_grants=((tok, rng.randint(1, 2)),)
                if tok is not None else (), segment_words=SEG))
        elif r < 0.85:
            out.append(CommEvent(
                seq=0, op="mailbox_flush", pattern=((0, 1),),
                writes=(Interval(start, words),), token=tok, acked=True,
                mailbox_id=rng.randint(1, 2), segment_words=SEG))
        else:
            out.append(CommEvent(
                seq=0, op="get_medium", pattern=((0, 1),),
                reads=(Interval(start, words),), token=tok, acked=True,
                segment_words=SEG))
    return out


def _fuzzed(seed):
    """A test_comm_lint schedule, its reference events, and the same
    events with extras inserted, waivers sprinkled, seqs renumbered."""
    from test_comm_lint import _random_schedule, _to_events

    rng = random.Random(seed)
    sched = _random_schedule(rng)
    base = _to_events(sched)
    mixed = list(base)
    for ev in _extra_events(rng):
        mixed.insert(rng.randint(0, len(mixed)), ev)
    out = []
    for i, ev in enumerate(mixed):
        waiver = "intended" if rng.random() < 0.1 else None
        out.append(dataclasses.replace(ev, seq=i, waiver=waiver,
                                       tag=f"shoal.{ev.op}#e{i}"))
    return sched, base, out


def _to_port(events):
    """The same events as the port's :class:`CommEvent`, field for
    field."""
    from repro_torch.analysis import trace as pt

    out = []
    for ev in events:
        kw = {f.name: getattr(ev, f.name) for f in dataclasses.fields(ev)}
        kw["writes"] = tuple(pt.Interval(i.start, i.words)
                             for i in ev.writes)
        kw["reads"] = tuple(pt.Interval(i.start, i.words) for i in ev.reads)
        kw["detail"] = dict(ev.detail)
        out.append(pt.CommEvent(**kw))
    return out


@pytest.mark.parametrize("chunk", range(6))
def test_rules_match_reference_on_fuzzed_schedules(chunk):
    from repro.analysis import rules as ref_rules

    from repro_torch.analysis import rules

    for seed in range(chunk * 50, (chunk + 1) * 50):
        _, base, mixed = _fuzzed(seed)
        for events in (base, mixed):
            want = _findings_json(ref_rules.analyze(events))
            got = _findings_json(rules.analyze(_to_port(events)))
            assert got == want, f"seed {seed}: {got} != {want}"


@pytest.mark.parametrize("chunk", range(2))
def test_rules_match_sequential_oracle(chunk):
    """The property of tests/test_comm_lint.py, on the port's rules."""
    from actor_checks import sequential_schedule_oracle
    from test_comm_lint import SEG as ORACLE_SEG

    from repro_torch.analysis import ERROR, WARNING, lint_events

    for seed in range(chunk * 60, (chunk + 1) * 60):
        sched, base, _ = _fuzzed(seed)
        oracle = sequential_schedule_oracle(sched, ORACLE_SEG)
        rep = lint_events(_to_port(base), name=f"fuzz-{seed}")
        r1 = {f.events for f in rep.findings if f.rule == "R1"}
        assert r1 == {tuple(p) for p in oracle["unordered_overlaps"]}, seed
        if not r1:
            assert not oracle["divergent"], seed
        under = {f.events[0] for f in rep.findings
                 if f.rule == "R3" and f.severity == ERROR}
        assert under == set(oracle["underflow_events"]), seed
        warn = sum(1 for f in rep.findings
                   if f.rule == "R3" and f.severity == WARNING)
        assert warn == len(oracle["leaked_tokens"]) \
            + len(oracle["stranded_acks"]), seed


# --------------------------------------------------------------------------
# op-level parity against the live reference
# --------------------------------------------------------------------------

def _strip(events):
    return [{k: v for k, v in e.items() if k not in ("seq", "tag")}
            for e in events]


@pytest.mark.parametrize("name", [
    "strided-prefix-race", "strided-ordered", "overlap-pair",
    "overlap-pair-waited", "disjoint-pair", "get-inflight",
    "get-after-wait", "underflow", "leak", "double-spend", "oob",
    "vectored-alias", "vectored-alias-waived", "vectored-alias-waived-4",
    "multi-alias-waived"])
def test_probe_matches_reference(reference, name):
    from repro_torch.analysis import registry

    doc, _ = reference
    want = doc["probes"][name]
    probe = registry.get_probe(name)
    if "raises" in want:
        assert probe.raises is not None
        assert want["raises"] == probe.raises.__name__ == "VectoredAliasError"
        with pytest.raises(probe.raises, match="overlap"):
            registry.run_probe(name, device="cpu")
        return
    run = registry.run_probe(name, device="cpu")
    assert _findings_json(run.report.findings) == want["findings"]
    assert events_json(run.events) == want["events"]
    rep = run.report
    assert tuple(f.rule for f in rep.findings if not f.waived) \
        == probe.expect
    assert tuple(f.rule for f in rep.waived) == probe.waived


@pytest.mark.parametrize("name", ENTRIES)
def test_entry_matches_reference(reference, name):
    from repro_torch.analysis import registry

    doc, arrays = reference
    want = doc["entries"][name]
    if name == "kv-migrate":
        params = _kv_params(arrays)
        run = registry.run_program(
            name, lambda d: registry.build_kv_migrate(d, params), "cpu")
        np.testing.assert_array_equal(run.result.segment.numpy(),
                                      arrays["kv-migrate/segment"])
    else:
        run = registry.run_program(name, registry.get(name).build, "cpu")
    assert run.report.ok and want["findings"] == []
    assert _findings_json(run.report.findings) == want["findings"]
    got = events_json(run.events)
    if name != "jacobi-steady":
        assert got == want["events"]
        return
    # one scan instance in the reference: 5 iteration events + 4 drains
    ref = _strip(want["events"])
    assert len(ref) == 9 and len(got) == 5 * STEADY_ITERS + 4
    assert _strip(got) == ref[:5] * STEADY_ITERS + ref[5:]


def _kv_params(arrays):
    """The reference entry's parameters, carried across."""
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.models.model import ModelConfig, build_model
    from repro_torch.tree import tree_unflatten

    cfg = ModelConfig(name="lint-kv", family="dense", n_layers=2, d_model=32,
                      n_heads=2, n_kv_heads=2, d_ff=64, vocab=64,
                      dtype=torch.float32)
    model = build_model(cfg, device="cpu")
    like = model.init(torch.Generator().manual_seed(0))
    n = sum(1 for k in arrays if k.startswith("kv-params/"))
    leaves = [arrays[f"kv-params/{i}"] for i in range(n)]
    return params_from_numpy(cfg, tree_unflatten(like, leaves), device="cpu")


@pytest.mark.parametrize("name", WAIVED_RUNS)
def test_waived_packet_lands_as_the_reference(reference, name):
    """A waived aliasing packet ships and lands the reference's words:
    in block (item) order, the later block winning where they meet."""
    from repro_torch.analysis import registry

    _, arrays = reference
    run = registry.run_probe(name, device="cpu")
    seg = run.result.segment.numpy()
    np.testing.assert_array_equal(seg, arrays[f"{name}/segment"])
    np.testing.assert_array_equal(run.result.credits.numpy(),
                                  arrays[f"{name}/credits"])
    if name.startswith("vectored"):
        # blocks 0 at [8, 12) and 1 at [10, 14): block 1 wins on [10, 12)
        np.testing.assert_array_equal(seg[:, 8:10], np.tile([10., 11.],
                                                           (N, 1)))
        np.testing.assert_array_equal(seg[:, 10:14],
                                      np.tile([20., 21., 22., 23.], (N, 1)))


def test_unwaived_alias_still_raises():
    from repro_torch.analysis import waiver
    from repro_torch.core import ops
    from repro_torch.core.state import ShoalContext

    ctx = ShoalContext(N, segment_words=64, device="cpu")
    st = ctx.make_state()
    blocks = [torch.ones(N, 4), torch.ones(N, 4)]
    with pytest.raises(ops.VectoredAliasError, match="waiver"):
        ops.put_long_vectored(ctx, st, blocks, RING, [8, 10])
    pay = torch.ones(N, 8)
    back = [(d, s) for s, d in RING]
    with pytest.raises(ops.VectoredAliasError, match="waiver"):
        ops.put_long_multi(ctx, st, [(pay, RING, 8), (pay, back, 12)])
    with waiver("deliberate"):
        st = ops.put_long_vectored(ctx, st, blocks, RING, [8, 10])
    assert bool((st.credits[:, 0] == 1).all())
    with pytest.raises(ValueError, match="reason"):
        with waiver("  "):
            pass


# --------------------------------------------------------------------------
# budgets and lossy-put
# --------------------------------------------------------------------------

BUDGET_EXCHANGES = {"jacobi": 4, "jacobi-steady": 10, "actors-mailbox": 2,
                    "kv-migrate": 2, "lossy-put": 10}


@pytest.mark.parametrize("name", sorted(BUDGET_EXCHANGES))
def test_entry_meets_its_budget(name):
    from repro_torch.analysis import registry

    run = registry.lint_entry(name, device="cpu")
    assert run.report.ok, run.report.render()
    assert run.exchanges == BUDGET_EXCHANGES[name]
    assert run.report.budget["ops"]["collective-permute"] \
        == BUDGET_EXCHANGES[name]
    assert sum(run.tags.values()) == run.exchanges
    assert run.report.tags_recovered == len(run.tags) > 0


def test_tighter_budget_names_the_op():
    from repro_torch.analysis import ERROR, budget, registry

    budgets = budget.load_budgets()
    budgets["jacobi"] = dict(budgets["jacobi"], collective_permute_max=3)
    rep = registry.run_entry("jacobi", budgets, device="cpu")
    b1 = [f for f in rep.findings if f.rule == "B1"]
    assert len(b1) == 1 and b1[0].severity == ERROR and not rep.ok
    assert "shoal.put_long_multi#e0: 1" in b1[0].message
    assert "put_long_multi#e0" in b1[0].sites
    budgets["kv-migrate"] = {"collective_permute_exact": 3}
    rep = registry.run_entry("kv-migrate", budgets, device="cpu")
    assert "put_long_vectored#e0: 2" in rep.findings[0].message


# the nine [micro.*] sections: tests/hlo_budget_checks.py's programs and
# the exchanges the compiled JAX programs count (comm_budgets.toml)
MICRO_EXCHANGES = {"micro.put_long_acked_4seg": 2,
                   "micro.put_long_async_4seg": 1,
                   "micro.get_medium_4seg": 2,
                   "micro.put_long_vectored": 2,
                   "micro.jacobi_iter_segmenting": 4,
                   "micro.put_long_multi_merged": 2,
                   "micro.put_long_multi_deferred": 1,
                   "micro.put_long_bf16_fallback": 3,
                   "micro.multi_mailbox_flush": 2}


def test_every_micro_section_has_a_program():
    from repro_torch.analysis import budget, registry

    sections = sorted(k for k in budget.load_budgets()
                      if k.startswith("micro."))
    assert sections == sorted(m.name for m in registry.MICROS) \
        == sorted(MICRO_EXCHANGES)
    with pytest.raises(KeyError, match="unknown micro program"):
        registry.check_micro("micro.nothing", device="cpu")


@pytest.mark.parametrize("name", sorted(MICRO_EXCHANGES))
def test_micro_meets_its_budget(name):
    """Each ``[micro.*]`` program through ``budget.measure`` and
    ``check_budget`` against its section: no finding, the section's
    exact exchange count, every exchange attributed to an op."""
    from repro_torch.analysis import budget, registry

    run, findings = registry.check_micro(name, device="cpu")
    assert not findings, [f.render() for f in findings]
    assert run.exchanges == MICRO_EXCHANGES[name] == budget.load_budgets()[
        name]["collective_permute_exact"]
    assert sum(run.tags.values()) == run.exchanges
    assert not any(run.collectives.values())


def test_micro_off_its_budget_is_a_b1_error():
    from repro_torch.analysis import ERROR, budget, registry

    budgets = budget.load_budgets()
    budgets["micro.put_long_acked_4seg"] = {"collective_permute_exact": 1}
    _, findings = registry.check_micro("micro.put_long_acked_4seg", budgets,
                                       device="cpu")
    assert len(findings) == 1 and findings[0].severity == ERROR
    assert "measured collective-permute 2 != declared budget 1" in \
        findings[0].message and "shoal.put_long#e0: 2" in findings[0].message


def test_unmeasured_budget_key_warns():
    """``wire_bytes`` is the one budget metric the port does not
    measure: a WARNING, never a pass.  The collective kinds are
    measured (``moe-dispatch``'s keys meet a run of 4 all-to-alls)."""
    from repro_torch.analysis import WARNING, budget

    spec = dict(budget.load_budgets()["moe-dispatch"], wire_bytes_max=1e6)
    measured = budget.measure(0, {"all_to_all": 4, "all_reduce": 2})
    findings = budget.check_budget("moe-dispatch", measured, spec)
    assert [(f.rule, f.severity) for f in findings] == [("B1", WARNING)]
    assert "wire_bytes_max" in findings[0].message
    assert "not measured" in findings[0].message
    assert measured["total_collectives"] == 6
    assert budget.check_budget("x", budget.measure(1), None)[0].severity \
        == WARNING
    with pytest.raises(ValueError, match="unknown metric"):
        budget.check_budget("x", budget.measure(1), {"bogus_max": 1})


MOE = "moe-dispatch"
# 2 MoE layers on 4 kernels: 2 all-to-alls (1 exchange each) and the
# aux's all-reduce (2 (K - 1) = 6 exchanges) a layer
MOE_EXCHANGES = 2 * (2 + 6)
MOE_OPS = {"collective-permute": MOE_EXCHANGES, "all-to-all": 4.0,
           "all-reduce": 2.0}


def test_moe_dispatch_report():
    """The port's entry: clean, no Shoal event, 4 all-to-alls (exactly
    the budget, and the JAX entry's compiled count in
    ``BENCH_comm.json``) and 6 collectives (<= 25), no key left
    unmeasured; the loss finite."""
    from repro_torch.analysis import registry

    run = registry.lint_entry(MOE, device="cpu")
    rep = run.report
    assert rep.ok and not rep.findings, rep.render()
    assert rep.n_events == 0 and run.events == [] and run.tags == {}
    assert run.collectives == {"all_to_all": 4, "all_reduce": 2,
                               "all_gather": 0, "reduce_scatter": 0}
    assert run.exchanges == MOE_EXCHANGES
    assert rep.budget["ops"] == MOE_OPS
    assert sum(run.collectives.values()) <= rep.budget["budget"][
        "total_collectives_max"]
    assert bool(torch.isfinite(run.result))
    with open(os.path.join(REPO, "BENCH_comm.json")) as f:
        jax_row = json.load(f)["current"]["comm_lint"]["entries"][MOE]
    assert jax_row["n_events"] == rep.n_events == 0
    assert jax_row["budget"]["ops"]["all-to-all"] == MOE_OPS["all-to-all"]


@pytest.mark.parametrize("key,value", [("all_to_all_exact", 3),
                                       ("total_collectives_max", 5)])
def test_moe_dispatch_broken_budget_is_a_b1_error(key, value):
    from repro_torch.analysis import ERROR, budget, registry

    budgets = budget.load_budgets()
    budgets[MOE] = dict(budgets[MOE], **{key: value})
    rep = registry.run_entry(MOE, budgets, device="cpu")
    assert not rep.ok
    assert [(f.rule, f.severity) for f in rep.findings] == [("B1", ERROR)]
    assert "collective calls drifted" in rep.findings[0].message
    assert key.rsplit("_", 1)[0].replace("_", "-") in rep.findings[0].message


def test_lossy_put_report():
    """The reference cannot lint this entry on the CPU (its scan-carry
    caveat); the port's report is clean, meets its budget, and records
    the reliable put's retransmit and dedup."""
    from repro_torch.analysis import registry

    run = registry.lint_entry("lossy-put", device="cpu")
    assert run.report.ok and not run.report.findings
    put = run.events[0]
    assert (put.op, put.lossy, put.retries, put.dedup, put.acked) \
        == ("put_long", True, 4, True, True)
    assert run.events[1].op == "wait_replies"
    assert run.tags == {"shoal.put_long#e0": 10}


# --------------------------------------------------------------------------
# the hooks' cost, tensor operands, strided overlap
# --------------------------------------------------------------------------

def _count_ops():
    from torch.utils._python_dispatch import TorchDispatchMode

    class CountOps(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.append(str(func))
            return func(*args, **(kwargs or {}))

    return CountOps


def _jacobi_ops(iters, recording):
    from repro_torch.analysis import record
    from repro_torch.analysis.registry import _tiny_tcp
    from repro_torch.apps.jacobi import JacobiApp
    from repro_torch.core.address_space import GlobalAddressSpace

    app = JacobiApp(n=64, kernels=N, iters=iters, transport=_tiny_tcp(),
                    device="cpu")
    st = GlobalAddressSpace(app.ctx).make_global_state()
    blocks = torch.ones(N, 8, 64)
    app.run_blocks(st, blocks)                  # builds the ctx tables
    st = GlobalAddressSpace(app.ctx).make_global_state()
    with _count_ops()() as mode:
        if recording:
            with record() as rec:
                app.run_blocks(st, blocks)
            assert len(rec.events) == 5 * iters + 4
        else:
            app.run_blocks(st, blocks)
    return mode.names


def test_recording_adds_no_aten_operation():
    """The same Jacobi run dispatches the same aten operations with the
    recorder off and on: the hooks run no tensor operation either way."""
    off = [_jacobi_ops(i, False) for i in (1, 3)]
    on = [_jacobi_ops(i, True) for i in (1, 3)]
    assert off == on
    assert len(off[1]) > len(off[0])


def test_tensor_operands_are_not_read():
    """Under a recorder a tensor address, token or count is recorded as
    unknown and never read (no ``_local_scalar_dense``)."""
    from repro_torch.analysis import record
    from repro_torch.core import ops
    from repro_torch.core.state import ShoalContext

    ctx = ShoalContext(N, segment_words=64, device="cpu")
    addr = torch.arange(N, dtype=torch.int32) * 2
    tok = torch.tensor(1)

    def prog(st):
        st = ops.put_long(ctx, st, torch.ones(N, 4), RING, dst_addr=addr,
                          token=tok)
        st = ops.put_long_vectored(ctx, st, [torch.ones(N, 2)], RING,
                                   [torch.tensor(30)], token=tok)
        return ops.wait_replies(ctx, st, token=tok, n=torch.tensor(2))

    prog(ctx.make_state())                      # builds the ctx tables
    counts = []
    for recording in (False, True):
        st = ctx.make_state()
        with _count_ops()() as mode:
            if recording:
                with record() as rec:
                    prog(st)
            else:
                prog(st)
        counts.append(mode.names)
    assert counts[0] == counts[1]
    put, vec, wait = rec.events
    assert put.writes[0].start is None and put.token is None
    assert vec.writes[0].start is None and vec.token is None
    assert wait.token is None and wait.wait_n is None


def test_strided_overlap_changes_the_event_not_the_bits():
    from repro_torch.analysis import record
    from repro_torch.core import gascore as gc, ops
    from repro_torch.core.state import ShoalContext, state_to_numpy

    ctx = ShoalContext(N, segment_words=64, device="cpu")
    pay = torch.arange(N * 16, dtype=torch.float32).reshape(N, 16)
    states, events = [], []
    for overlap in (True, False, None):
        with record() as rec:
            st = ops.put_long_strided(ctx, ctx.make_state(), pay, RING, 3,
                                      2, blk_words=4, nblocks=4,
                                      overlap=overlap, token=1)
        states.append(state_to_numpy(st))
        events.append(rec.events[0])
    for f in states[0]:
        np.testing.assert_array_equal(states[0][f], states[1][f])
        np.testing.assert_array_equal(states[0][f], states[2][f])
    assert [(e.ordered_ingress, e.self_overlap) for e in events] \
        == [(True, False), (False, True), (True, False)]
    assert [iv.start for iv in events[0].writes] == [3, 5, 7, 9]
    hdr = torch.zeros(N, 16, dtype=torch.int32)
    a = gc.ingress_strided_batch(ctx, ctx.make_state(), hdr[:, None],
                                 pay[:, None], 4, 4, True)
    b = gc.ingress_strided_batch(ctx, ctx.make_state(), hdr[:, None],
                                 pay[:, None], 4, 4)
    assert torch.equal(a.segment, b.segment)


def test_lint_refuses_exchanges_without_events():
    from repro_torch.analysis import lint
    from repro_torch.core import ops
    from repro_torch.core.state import ShoalContext

    ctx = ShoalContext(N, segment_words=16, device="cpu")
    with pytest.raises(RuntimeError, match="no event was recorded"):
        lint(lambda: ops._permute(ctx, RING, torch.zeros(N, 2)))
    rep = lint(lambda: None, name="empty")
    assert rep.ok and rep.n_events == 0


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------

def _cli():
    spec = importlib.util.spec_from_file_location(
        "torch_comm_lint", os.path.join(REPO, "scripts",
                                        "torch_comm_lint.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_cli_clean_over_the_entries(tmp_path):
    out = tmp_path / "lint.json"
    assert _cli().main(["--device", "cpu", "--json", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert sorted(doc["entries"]) == sorted([*BUDGET_EXCHANGES, MOE])
    for name, row in doc["entries"].items():
        assert row["ok"] and not row["findings"], name
        assert row["budget"]["ops"]["collective-permute"] \
            == {**BUDGET_EXCHANGES, MOE: MOE_EXCHANGES}[name]
    assert doc["entries"][MOE]["budget"]["ops"] == MOE_OPS


def test_cli_fails_on_a_racy_entry(monkeypatch, capsys):
    from repro_torch.analysis import registry

    racy = registry.Entry("racy", "two overlapping puts", N,
                          registry.get_probe("overlap-pair").build)
    monkeypatch.setattr(registry, "ENTRIES", registry.ENTRIES + (racy,))
    assert _cli().main(["--device", "cpu", "--entry", "racy",
                        "--no-budget"]) == 1
    assert "[R1/ERROR]" in capsys.readouterr().out


if __name__ == "__main__":
    _run_reference(sys.argv[1])
