"""The port's span and counter recorder (``repro_torch.runtime.spans``) on
the CPU.

* Off, the default: ``span`` is one shared null context; it reads no
  clock, opens no ``record_function``, runs no tensor operation and
  keeps nothing, and a profiler around a trainer step sees no span of
  the program.
* On: spans nest per thread; a span opened on another thread while
  ``model.backward`` is open (autograd's worker, on a card) hangs under
  it; under ``dots`` the recomputed blocks carry ``recompute=True``
  beside their forward twins, and the step's counters count the forward
  once.
* Every recorded span matches its ``record_function`` range in the
  profiler's trace within 50 us at both ends: one clock.
* Recording changes no number: a small trainer's loss and gradients are
  bitwise the same on and off, on both backends (dbrx-smoke
  expert-parallel over 4 kernels under ``xla``; tinyllama-smoke over 2
  shoal members).
"""

import contextlib
import dataclasses
import threading
import time
import tracemalloc

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import configs
from repro_torch.core.state import ShoalContext
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import spans
from repro_torch.training import Trainer, TrainerConfig
from repro_torch.tree import tree_leaves

PREFIXES = ("train.", "model.", "attention.", "moe.", "optim.", "shoal.")


def _trainer(backend: str, remat: str = "dots"):
    """dbrx-smoke expert-parallel (``xla``) or tinyllama-smoke over 2
    shoal members, float32, and a batch of 4 x 16."""
    arch = "dbrx-132b" if backend == "xla" else "tinyllama-1.1b"
    cfg = dataclasses.replace(configs.reduced(arch), remat=remat,
                              dtype=torch.float32)
    ep = (tmoe.ExpertMesh(ShoalContext(4, device="cpu"))
          if backend == "xla" else None)
    tr = Trainer(tmodel.build_model(cfg, device="cpu", ep=ep),
                 AdamWConfig(lr=1e-3), TrainerConfig(comm_backend=backend),
                 kernels=2 if backend == "shoal" else 1)
    state = tr.init_state(torch.Generator().manual_seed(0))
    tok = torch.randint(0, cfg.vocab, (4, 17),
                        generator=torch.Generator().manual_seed(1))
    return tr, state, {"tokens": tok[:, :-1], "labels": tok[:, 1:]}


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func)
        return func(*args, **(kwargs or {}))


def _program_annotations(prof) -> list:
    return [e.name() for e in prof.profiler.kineto_results.events()
            if e.is_user_annotation() and e.name().startswith(PREFIXES)]


def test_off_is_one_shared_null_context(monkeypatch):
    assert spans.span("model.ffn", layer=3) is spans.span("train.step")
    assert spans.span("x").__enter__() is None and not spans.counting()

    def refuse(*args, **kwargs):
        raise AssertionError("read or opened while recording is off")

    with monkeypatch.context() as m:
        m.setattr(time, "time_ns", refuse)
        m.setattr(torch.profiler, "record_function", refuse)
        with _Ops() as mode:
            for i in range(100):
                with spans.span("model.attention", layer=i):
                    spans.add("moe.kept_pairs", 1)
        assert mode.ops == []

    def loop():
        for i in range(10_000):
            with spans.span("model.attention", layer=i):
                pass

    loop()
    tracemalloc.start()
    try:
        start, _ = tracemalloc.get_traced_memory()
        tracemalloc.reset_peak()
        loop()
        now, peak = tracemalloc.get_traced_memory()
        assert now - start < 1024 and peak - start < 1024
        with spans.recording():          # the same check sees records
            loop()
            kept, _ = tracemalloc.get_traced_memory()
        assert kept - start > 10_000 * 32
    finally:
        tracemalloc.stop()


def test_a_step_off_shows_no_program_span():
    tr, state, batch = _trainer("xla")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.step(state, batch)
    assert _program_annotations(prof) == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.recording() as rec:
            tr.step(state, batch)
    assert sorted(_program_annotations(prof)) == sorted(
        s.name for s in rec.spans)


def test_spans_nest_per_thread_and_hang_under_the_backward():
    with spans.recording() as rec:
        with spans.span("train.step"):
            with spans.span("model.backward") as back:
                opened = []

                def worker():          # autograd's thread on a card
                    with spans.span("model.ffn", layer=1) as s:
                        with spans.span("moe.experts") as inner:
                            opened.extend([s, inner, spans.counting()])

                t = threading.Thread(target=worker)
                t.start()
                t.join()
                with spans.span("shoal.all_reduce") as here:
                    pass
        with spans.span("train.step") as second:
            with spans.span("model.forward") as fwd:
                assert spans.counting()
    ffn, inner, counting = opened
    assert (ffn.parent, inner.parent, here.parent) == (back.id, ffn.id,
                                                       back.id)
    assert ffn.thread != back.thread == here.thread
    assert ffn.attrs == {"layer": 1, "recompute": True} and not counting
    assert "recompute" not in inner.attrs        # not a block span
    assert (back.step, ffn.step, second.step, fwd.step) == (0, 0, 1, 1)
    assert rec.path(inner) == ("train.step/model.backward/"
                               "model.ffn[recompute]/moe.experts")
    assert all(s.end >= s.start for s in rec.spans)


def test_dots_recompute_carries_its_flag_and_counts_once():
    tr, state, batch = _trainer("xla")
    with spans.recording() as rec:
        tr.step(state, batch)
    ids = rec.by_id()
    paths = [rec.path(s, ids) for s in rec.spans]
    layers = tr.model.cfg.n_layers
    for name in ("model.attention", "model.ffn"):
        fwd = [s for s in rec.spans if s.name == name
               and "recompute" not in s.attrs]
        again = [s for s in rec.spans if s.name == name
                 and s.attrs.get("recompute")]
        assert [s.attrs["layer"] for s in fwd] == list(range(layers))
        # the backward recomputes the last layer first
        assert [s.attrs["layer"] for s in again] == list(range(layers))[::-1]
        assert all(rec.path(s, ids).startswith(
            "train.step/model.backward/") for s in again)
    assert "train.step/model.forward/model.ffn/moe.experts" in paths
    assert "train.step/model.backward/model.ffn[recompute]/moe.experts" \
        in paths
    # 4 kernels x 2 layers of forward dispatch, the recompute not counted
    moe = tr.model.cfg.moe
    tokens = batch["tokens"].numel()
    cap = max(1, int(tokens * moe.top_k * moe.capacity_factor
                     / moe.n_experts))
    assert rec.counters["moe.slots"] == layers * moe.n_experts * cap
    assert rec.counters["moe.routed_pairs"] == layers * tokens * moe.top_k


def test_spans_share_the_profilers_clock():
    """Every span's ends lie within 50 us of its ``record_function``
    range's.  A thread preempted between the clock read and the range's
    own shows in one step; another clock would show in every step: each
    span's best of five steps is held to the bound."""
    tr, state, batch = _trainer("shoal")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.step(state, batch)                     # warm the profiler
        recs = []
        for _ in range(5):
            with spans.recording() as rec:
                tr.step(state, batch)
            recs.append(rec)
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation() and e.name().startswith(PREFIXES):
            ranges.setdefault(e.name(), []).append((e.start_ns(),
                                                    e.end_ns()))

    def skews(rec):
        out = []
        for s in rec.spans:
            near = min(ranges[s.name], key=lambda r: abs(r[0] - s.start))
            out.append(max(abs(near[0] - s.start), abs(near[1] - s.end)))
        return out

    steps = [skews(rec) for rec in recs]
    assert len({len(x) for x in steps}) == 1 and steps[0]
    best = [min(col) for col in zip(*steps)]
    assert max(best) <= 50_000, sorted(best)[-5:]


@pytest.mark.parametrize("backend", ["xla", "shoal"])
def test_recording_changes_no_number(backend):
    tr, state, batch = _trainer(backend)
    runs = []
    for on in (False, True, False):
        with spans.recording() if on else contextlib.nullcontext():
            loss, grads, _ = tr.grads(state, batch)
        runs.append((loss, tree_leaves(grads)))
    for loss, grads in runs[1:]:
        assert torch.equal(loss, runs[0][0])
        assert all(torch.equal(a, b) for a, b in zip(grads, runs[0][1]))


def test_one_recording_at_a_time():
    with spans.recording():
        with pytest.raises(RuntimeError, match="already active"):
            with spans.recording():
                pass
    assert not spans.counting()


def test_lint_scopes_open_spans_of_the_same_name():
    """With shoal-lint's recorder and a recording both on, an op's scope
    tag is a span of the op's name; the exchanges stay on the context."""
    from repro_torch.analysis import trace
    from repro_torch.core import ops

    ctx = ShoalContext(4, segment_words=64, device="cpu")
    ring = [(i, (i + 1) % 4) for i in range(4)]
    st = ctx.make_state()
    with trace.record() as lint, spans.recording() as rec:
        st = ops.put_short(ctx, st, ring)
        st = ops.put_long(ctx, st, torch.ones(4, 8), ring, dst_addr=8)
    assert [(s.name, s.attrs["tag"]) for s in rec.spans] == [
        ("shoal.put_short", "shoal.put_short#e0"),
        ("shoal.put_long", "shoal.put_long#e1")]
    tags = trace.recover_tags(lint)
    assert set(tags) == {"shoal.put_short#e0", "shoal.put_long#e1"}
    assert sum(tags.values()) == ctx.exchanges > 0
    with trace.record():                     # lint alone: no span
        ops.put_short(ctx, st, ring)
    assert not spans.counting()
