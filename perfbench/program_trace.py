"""The program-traced pass of a traced training run: the program's own
spans and counters (``repro_torch.runtime.spans``) laid over the
device's trace, where both share one clock.

The first per-layer reader that asks for it (:func:`of`) builds the
cell's trainer again from the run's seed (``drivers/train.py`` has
freed its own by then), runs one step to warm it, and runs the mix's
``profile_steps`` under ``torch.profiler`` with ``spans.recording()`` on
and ``drivers.train.RingBytes`` counting beside
``ShoalContext.ring_bytes``.  The training driver's own profiled step
runs with recording off, so every reading it gives keeps its meaning.
What the pass reads lands in ``rec["program"]``, per step:

* ``paths``: for every span path (``train.step/train.member/...``; a
  recomputed block ``model.ffn[recompute]``; the backward of a forward
  span ``model.backward/model.attention[grad]``) its device ms, idle ms
  and calls.  A device activity belongs to the span in whose host
  interval its launch call falls, on any thread, found through the
  profiler's launch correlation.  Work that autograd runs outside any
  span on its own thread (a backward node) is found through the node's
  forward operation (its sequence number) and lands under the forward
  span it came from, marked ``[grad]``.  Overlapping activities count
  once (the union), so device ms over all paths plus ``device_outside_ms``
  is the pass's busy time.  Each idle gap of the merged activities, and
  the window's head and tail, goes to the innermost span open at the
  gap's start; with ``idle_outside_ms`` that is the window minus the
  busy time.
* ``host_syncs``: by innermost span, inside ``train.step``: the runtime
  calls ``cudaStreamSynchronize``, ``cudaDeviceSynchronize`` and
  ``cudaEventSynchronize`` and every copy that blocks the host
  (device to host, or from pageable memory), one per operation that
  makes them.
* ``counters`` (the recording's), ``ring_bytes`` (``ctx.ring_bytes`` over
  the pass) beside ``ring_bytes_harness`` (``RingBytes``), the window and
  the busy time.

The pass needs the spans module; on a program without it, ``of`` gives
None and the readers stay silent.
"""

from __future__ import annotations

import argparse
import bisect
import gc
import importlib.util
import sys
import time

SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")
WARM_STEPS = 1
TOP = 20
BACKWARD, FORWARD = "model.backward", "model.forward"


def of(rec: dict):
    """``rec["program"]`` of a training record, the pass run at the first
    call; None for a serving record or a program without spans."""
    if rec.get("kind") != "train":
        return None
    if "program" not in rec:
        rec["program"] = _measure(rec)
    return rec["program"]


def base(segment: str) -> str:
    """A path segment's span name (``model.ffn[recompute]`` ->
    ``model.ffn``)."""
    return segment.split("[", 1)[0]


def span_sum(prog, key: str, names, device: bool = True):
    """The sum of ``key`` over the paths through any span of ``names``;
    None without such a path, or for a device reading off the card."""
    if prog is None or (device and prog["platform"] != "cuda"):
        return None
    hits = [v[key] for p, v in prog["paths"].items()
            if any(base(s) in names for s in p.split("/"))]
    return sum(hits) if hits else None


# --------------------------------------------------------------------------
# the pass
# --------------------------------------------------------------------------

def _invocation():
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    args, _ = p.parse_known_args(sys.argv[1:])
    return args.workload, args.seed


def _measure(rec: dict):
    try:
        found = importlib.util.find_spec("repro_torch.runtime.spans")
    except ImportError:
        found = None
    if found is None:
        return None
    import torch

    from perfbench import bench

    workload, seed = _invocation()
    cell = bench.load_cell(bench.ROOT, workload)
    device = (torch.device("cuda", 0) if rec["platform"] == "cuda"
              else torch.device(rec["platform"]))
    t0 = time.perf_counter()
    prog = run_pass(cell, seed, device)
    prog["pass_s"] = time.perf_counter() - t0
    prog["untraced_window_s"] = rec["profile"]["window_s"]
    prog["untraced_ring_bytes"] = rec.get("ring_bytes")
    report(prog)
    return prog


def run_pass(cell, seed: int, device) -> dict:
    """Build the cell's trainer, warm it, and run ``profile_steps`` steps
    under the profiler with recording on; read the trace."""
    import torch
    from torch.profiler import ProfilerActivity

    from perfbench import bench, weights
    from perfbench.drivers import train
    from repro_torch.runtime import spans

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    m, mix = cell.config["model"], cell.mix
    tr, ctx = train.build(cell, device)
    specs = bench.family_module(cell, "reference").leaf_specs(m)
    state = tr.state_for(bench.family_module(cell, "layouts").port_tree(
        m, weights.draw(specs, seed, device, weights.DTYPES[m["dtype"]])))
    feed = train.Feed(seed, mix, m["vocab"], device)
    for _ in range(WARM_STEPS):
        state, _ = tr.step(state, feed.next())
    steps = mix["profile_steps"]
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    ring0 = dict(getattr(ctx, "ring_bytes", {})) if ctx else {}
    ex0 = ctx.exchanges if ctx else 0
    bench.sync(device)
    with torch.profiler.profile(activities=acts) as prof, \
            train.RingBytes() as ring:
        with spans.recording() as recd:
            t0, p0 = time.time_ns(), time.perf_counter()
            for _ in range(steps):
                state, _ = tr.step(state, feed.next())
            bench.sync(device)
            window = time.perf_counter() - p0
            t1 = time.time_ns()
    ring_bytes = ({k: v - ring0.get(k, 0) for k, v in ctx.ring_bytes.items()}
                  if ctx is not None else {})
    exchanges = (ctx.exchanges - ex0) if ctx else 0
    del tr, state, feed, ctx
    gc.collect()
    trace = events(prof, recd)
    del prof
    prog = attribute(trace, (t0, t1), steps)
    prog.update(platform=device.type, steps=steps, window_s=window,
                counters=dict(recd.counters), ring_bytes=ring_bytes,
                ring_bytes_harness=ring.bytes, exchanges=exchanges / steps,
                spans=len(recd.spans))
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return prog


def report(prog: dict) -> None:
    """The top span paths, the totals and the checks on stderr."""
    ranked = sorted(prog["paths"].items(),
                    key=lambda kv: -(kv[1]["device_ms"] + kv[1]["idle_ms"]))
    for path, v in ranked[:TOP]:
        print(f"perfbench: span {path} device_ms {v['device_ms']:.3f} "
              f"idle_ms {v['idle_ms']:.3f} calls {v['calls']:g}",
              file=sys.stderr)
    keys = ("pass_s", "window_s", "untraced_window_s", "busy_ms",
            "device_raw_ms", "window_ms",
            "device_outside_ms", "idle_outside_ms", "launches_located",
            "clock_skew_us", "host_syncs_per_step", "host_syncs",
            "counters", "ring_bytes",
            "ring_bytes_harness", "untraced_ring_bytes", "exchanges", "spans")
    print("perfbench: program " + " ".join(
        f"{k} {prog.get(k)!r}" for k in keys), file=sys.stderr)


# --------------------------------------------------------------------------
# the trace, as plain tuples
# --------------------------------------------------------------------------

def events(prof, recd) -> dict:
    """What :func:`attribute` reads of a profiler's trace and a
    recording, every thread named by the profiler's thread ids and every
    time in Unix nanoseconds:

    ``spans``      [(id, parent, path, thread, start, end)], the ends
                   those of the span's ``record_function`` range
    ``acts``       [(start, end, thread, launched_at)], device activities
                   (thread None where the launch was not found)
    ``nodes``      [(thread, start, end, (fwd_thread, seq))], autograd's
                   backward nodes
    ``fwd``        {(thread, seq): time}, the forward operations
    ``blocking``   [(thread, time, group)], host-blocking runtime calls
    ``skew``       the largest distance, in ns, between a span's ends and
                   its ``record_function`` range's
    """
    from torch.autograd import DeviceType

    raw = prof.profiler.kineto_results.events()
    ops, annot, runtime, device, nodes, fwd = {}, {}, {}, [], [], {}
    for e in raw:
        name = e.name()
        if e.device_type() != DeviceType.CPU:
            if not e.is_user_annotation():
                device.append(e)
            continue
        if e.is_user_annotation():
            annot.setdefault(name, []).append(
                (e.start_ns(), e.end_ns(), e.start_thread_id()))
            ops[e.correlation_id()] = e
        elif name.startswith("cu"):          # CUDA runtime and driver calls
            runtime[e.correlation_id()] = e
        else:
            ops[e.correlation_id()] = e
            seq = e.sequence_nr()
            if name.startswith("autograd::engine::evaluate_function"):
                nodes.append((e.start_thread_id(), e.start_ns(), e.end_ns(),
                              (e.fwd_thread_id(), seq)))
            elif seq >= 0 and not name.startswith("autograd::"):
                key = (e.start_thread_id(), seq)
                fwd[key] = min(fwd.get(key, e.start_ns()), e.start_ns())

    # the recording's spans on the profiler's threads, matched to their
    # record_function ranges by name and start
    for rows in annot.values():
        rows.sort()
    ids = recd.by_id()
    spans, py_thread, skew = [], {}, 0
    for s in recd.spans:
        rows = annot.get(s.name)
        start, end = s.start, s.end
        if rows:
            i = bisect.bisect_left(rows, (s.start,))
            start, end, thread = min(rows[max(0, i - 1):i + 1],
                                     key=lambda r: abs(r[0] - s.start))
            skew = max(skew, abs(start - s.start), abs(end - s.end))
            votes = py_thread.setdefault(s.thread, {})
            votes[thread] = votes.get(thread, 0) + 1
        spans.append([s.id, s.parent, recd.path(s, ids), s.thread,
                      start, end])
    tid = {py: max(c, key=c.get) for py, c in py_thread.items()}
    for row in spans:
        row[3] = tid.get(row[3], row[3])

    # a runtime call's thread: its linked operation's (the profiler names
    # the two in different ways), learnt by the majority over the calls
    os_votes = {}
    for r in runtime.values():
        op = ops.get(r.linked_correlation_id())
        if op is not None:
            c = os_votes.setdefault(r.start_thread_id(), {})
            c[op.start_thread_id()] = c.get(op.start_thread_id(), 0) + 1
    os_tid = {t: max(c, key=c.get) for t, c in os_votes.items()}

    def host_of(r):
        op = ops.get(r.linked_correlation_id())
        if r.start_thread_id() in os_tid:
            return os_tid[r.start_thread_id()], r.start_ns()
        if op is not None:
            return op.start_thread_id(), r.start_ns()
        return None, r.start_ns()

    acts, kinds = [], {}
    for d in device:
        r = runtime.get(d.correlation_id())
        if r is not None:
            thread, at = host_of(r)
        else:
            op = ops.get(d.linked_correlation_id())
            thread, at = ((op.start_thread_id(), op.start_ns())
                          if op is not None else (None, None))
        acts.append((d.start_ns(), d.end_ns(), thread, at))
        if r is not None and "Memcpy" in d.name():
            kinds[d.correlation_id()] = d.name()
    blocking = []
    for corr, r in runtime.items():
        name = r.name()
        copy = kinds.get(corr, "")
        if (name in SYNC_CALLS or name == "cudaMemcpy"
                or "DtoH" in copy or "Pageable" in copy):
            thread, at = host_of(r)
            linked = r.linked_correlation_id()
            blocking.append((thread, at, linked if linked > 0
                             else ("call", corr)))
    return {"spans": [tuple(r) for r in spans], "acts": acts,
            "nodes": nodes, "fwd": fwd, "blocking": blocking, "skew": skew}


# --------------------------------------------------------------------------
# attribution
# --------------------------------------------------------------------------

class _Nested:
    """Properly nested intervals of one thread: the innermost holding a
    time."""

    def __init__(self, rows):
        # rows: (start, end, value), sorted by start
        self.rows = sorted(rows, key=lambda r: (r[0], -r[1]))
        self.starts = [r[0] for r in self.rows]
        self.up, stack = [], []
        for i, (s, e, _) in enumerate(self.rows):
            while stack and self.rows[stack[-1]][1] <= s:
                stack.pop()
            self.up.append(stack[-1] if stack else -1)
            stack.append(i)

    def at(self, t):
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.rows[i][1] < t:
            i = self.up[i]
        return None if i < 0 else self.rows[i][2]


def attribute(trace: dict, window, steps: int) -> dict:
    """Device and idle ms, calls and host syncs a step by span path, from
    :func:`events`' tuples over the window ``(t0, t1)`` (ns)."""
    t0, t1 = window
    by_thread, any_thread, paths = {}, [], {}
    for sid, parent, path, thread, start, end in trace["spans"]:
        if end is None:
            continue
        row = (start, end, path)
        by_thread.setdefault(thread, []).append(row)
        any_thread.append(row)
        paths[path] = paths.get(path, 0) + 1
    index = {t: _Nested(rows) for t, rows in by_thread.items()}
    backward = _Nested([r for r in any_thread
                        if base(r[2].rsplit("/", 1)[-1]) == BACKWARD])
    node_index = {}
    for thread, start, end, key in trace["nodes"]:
        node_index.setdefault(thread, []).append((start, end, key))
    node_index = {t: _Nested(rows) for t, rows in node_index.items()}
    fwd = trace["fwd"]

    def grad_path(back: str, thread, t) -> str:
        """``back`` (a model.backward path) refined by the backward node
        running at ``t``: its forward span, marked ``[grad]``."""
        threads = [thread] if thread in node_index else list(node_index)
        for th in threads:
            key = node_index[th].at(t)
            if key is None or key not in fwd or key[0] not in index:
                continue
            origin = index[key[0]].at(fwd[key])
            if origin is None:
                return back
            segs = origin.split("/")
            names = [base(s) for s in segs]
            if FORWARD not in names:
                return back
            below = segs[names.index(FORWARD) + 1:]
            return "/".join([back] + [f"{base(s)}[grad]" for s in below])
        return back

    def locate(thread, t):
        """The span path of a host call at ``t`` on ``thread``."""
        path = index[thread].at(t) if thread in index else None
        if path is None:
            path = backward.at(t)
        if path is not None and base(path.rsplit("/", 1)[-1]) == BACKWARD:
            return grad_path(path, thread, t)
        return path

    def innermost(t):
        """The deepest span open at ``t`` on any thread."""
        best = None
        for th, ix in index.items():
            p = ix.at(t)
            if p is not None and (best is None
                                  or p.count("/") > best.count("/")):
                best = p
        if best is not None and base(best.rsplit("/", 1)[-1]) == BACKWARD:
            return grad_path(best, None, t)
        return best

    out = {p: {"device_ms": 0.0, "idle_ms": 0.0, "calls": n / steps}
           for p, n in paths.items()}

    def add(path, key, ns):
        row = out.setdefault(path, {"device_ms": 0.0, "idle_ms": 0.0,
                                    "calls": 0.0})
        row[key] += ns / 1e6 / steps

    acts = sorted((max(s, t0), min(e, t1), th, at)
                  for s, e, th, at in trace["acts"] if e > t0 and s < t1)
    cover, busy, located, raw = t0, 0, 0, 0
    outside_dev = outside_idle = 0
    merged = []
    for s, e, th, at in acts:
        raw += e - s
        part = max(0, e - max(s, cover))
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
        cover = max(cover, e)
        busy += part
        path = locate(th, at) if at is not None else None
        located += at is not None
        if path is None:
            outside_dev += part
        else:
            add(path, "device_ms", part)
    gaps, prev = [], t0
    for s, e in merged:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if t1 > prev:
        gaps.append((prev, t1))
    for s, e in gaps:
        path = innermost(s)
        if path is None:
            outside_idle += e - s
        else:
            add(path, "idle_ms", e - s)
    syncs, seen = {}, set()
    for th, at, group in trace["blocking"]:
        if group in seen or at is None or not t0 <= at <= t1:
            continue
        seen.add(group)
        path = locate(th, at)
        if path is not None and "train.step" in path.split("/"):
            syncs[path] = syncs.get(path, 0) + 1 / steps
    return {"paths": out, "busy_ms": busy / 1e6 / steps,
            "device_raw_ms": raw / 1e6 / steps,
            "window_ms": (t1 - t0) / 1e6 / steps,
            "device_outside_ms": outside_dev / 1e6 / steps,
            "idle_outside_ms": outside_idle / 1e6 / steps,
            "launches_located": (located / len(acts)) if acts else None,
            "clock_skew_us": trace["skew"] / 1e3,
            "host_syncs": syncs,
            "host_syncs_per_step": sum(syncs.values())}
