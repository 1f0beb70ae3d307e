"""What every cell shares: finding a cell's files by name, the spans the
harness records around its own calls into the program, the profiled
window and what is read from its trace, and the checks that decide
``correct``.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix;
the harness reads ``<config file>``, ``perfbench/traffic/<mix>.json``
(whose ``driver`` names ``perfbench/drivers/<driver>.py``),
``perfbench/workloads/<cell>.json`` (the limits of its checks) and, in
a traced run, ``perfbench/metrics/<metric>.py`` for each per-layer
metric of the cell.  Adding a cell, a mix or a metric adds files and
entries; no file here names one.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# top-level modules the port must not load (whole names: ``repro_torch``
# begins with ``repro`` and is the program)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    name: str
    chips: int
    config: dict             # the configuration file
    mix: dict                # the traffic mix file
    checks: dict             # the workload file: limits of the checks
    end_to_end: list         # metric entries the cell reports
    per_layer: list
    root: Path

    def driver(self):
        return importlib.import_module(
            f"perfbench.drivers.{self.mix['driver']}")

    def reader(self, metric: str):
        return load_module(self.root / "perfbench" / "metrics"
                           / f"{metric}.py", f"perfbench_metric_{metric}")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, name: str) -> Cell:
    bench = load_json(root / "BENCHMARK.json")
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{[w['name'] for w in bench['workloads']]}")
    w = found[0]
    cfg = next(c for c in bench["configs"] if c["name"] == w["config"])
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _applies(m, name) and m["moves"] in reported]
    return Cell(name=name, chips=w["chips"],
                config=load_json(root / cfg["file"]),
                mix=load_json(root / "perfbench" / "traffic"
                              / f"{w['traffic']}.json"),
                checks=load_json(root / "perfbench" / "workloads"
                                 / f"{name}.json"),
                end_to_end=e2e, per_layer=per_layer, root=root)


def family_module(cell: Cell, kind: str):
    """The configuration's ``reference`` or ``layouts`` module."""
    name = cell.config["family_module"]
    return load_module(cell.root / "perfbench" / kind / f"{name}.py",
                       f"perfbench_{kind}_{name}")


def port_config(config: dict):
    """The program's ``ModelConfig`` of a configuration file."""
    import torch
    from repro_torch.models.model import ModelConfig
    from repro_torch.models.moe import MoEDims

    m = dict(config["model"])
    moe = m.pop("moe", None)
    return ModelConfig(name=config["name"], dtype=getattr(torch, m.pop(
        "dtype")), moe=MoEDims(**moe) if moe else None, **m)


def forbidden_modules() -> list[str]:
    return sorted({n for n in list(sys.modules)
                   if n.split(".")[0] in FORBIDDEN})


# --------------------------------------------------------------------------
# the device
# --------------------------------------------------------------------------

def sync(device) -> None:
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def quantile(values, q: float) -> float:
    """The ``q`` quantile (0..1) of ``values``, linear between order
    statistics."""
    xs = sorted(values)
    pos = q * (len(xs) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


class Phases:
    """Seconds of a run's phases, each from the end of the one before
    (the first from the process's start), printed on standard error."""

    def __init__(self, start: float):
        self.last, self.seconds = start, {}

    def mark(self, name: str) -> None:
        now = time.time()
        self.seconds[name] = now - self.last
        self.last = now


# --------------------------------------------------------------------------
# spans around the harness's calls into the program
# --------------------------------------------------------------------------

class Probe:
    """Spans recorded around calls into the program's layers.  Installed
    with :meth:`wrap` on an object's method; while ``timing`` is set,
    each call is timed between device synchronisations (the device idle
    at both ends), and while ``labels`` is set it is named in a profiler
    trace (``pb:<span>``)."""

    def __init__(self, device):
        self.device = device
        self.timing = False
        self.labels = False
        self.seconds: dict[str, float] = {}
        self.calls: dict[str, int] = {}

    def wrap(self, obj, attr: str, span: str) -> None:
        fn = getattr(obj, attr)

        def spanned(*args, **kwargs):
            if not (self.timing or self.labels):
                return fn(*args, **kwargs)
            import torch

            if self.timing:
                sync(self.device)
                t0 = time.perf_counter()
            label = (torch.profiler.record_function(f"pb:{span}")
                     if self.labels else contextlib.nullcontext())
            with label:
                out = fn(*args, **kwargs)
            if self.timing:
                sync(self.device)
                self.seconds[span] = (self.seconds.get(span, 0.0)
                                      + time.perf_counter() - t0)
                self.calls[span] = self.calls.get(span, 0) + 1
            return out

        setattr(obj, attr, spanned)


# --------------------------------------------------------------------------
# the profiled window
# --------------------------------------------------------------------------

def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def profile(fn, device, top: int = 10, labelled_gaps: int = 200) -> dict:
    """Run ``fn`` under ``torch.profiler`` (a window that ends with a
    device synchronisation) and read its trace: ``busy_s`` (the union of
    the device's activities: kernels, copies, fills, and not the ``pb:``
    spans' annotations on its timeline), ``window_s`` (host clock),
    device seconds by activity name, the ``top`` activities, and the idle gaps between
    device activities summed by what the host was doing at each gap's
    start (its innermost host event, under the outermost ``pb:`` span),
    over the ``labelled_gaps`` longest gaps."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    sync(device)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        sync(device)
        window = time.perf_counter() - t0
    dev, host = [], []
    for e in prof.events():
        span = (e.time_range.start, e.time_range.end)
        if e.device_type == DeviceType.CPU:
            host.append((span, e.name))
        elif e.device_type == DeviceType.CUDA and not getattr(
                e, "is_user_annotation", False):
            dev.append((span, e.name))
    by_name: dict[str, float] = {}
    for (s, e), name in dev:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
    merged = _merge([span for span, _ in dev])
    busy = sum(e - s for s, e in merged) / 1e6
    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1])
                   for i in range(len(merged) - 1)), reverse=True)
    idle: dict[str, float] = {}
    if host and gaps:
        hs = np.array([s for (s, _), _ in host])
        he = np.array([e for (_, e), _ in host])
        names = [n for _, n in host]
        outer = np.array([n.startswith("pb:") for n in names])
        for length, at in gaps[:labelled_gaps]:
            cover = (hs <= at) & (he >= at)
            if not cover.any():
                label = "no host event"
            else:
                idx = np.flatnonzero(cover)
                inner = names[idx[np.argmax(hs[idx])]]
                spans = idx[outer[idx]]
                label = (f"{names[spans[np.argmin(hs[spans])]]}/{inner}"
                         if spans.size else inner)
            idle[label] = idle.get(label, 0.0) + length / 1e6
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {"busy_s": busy, "window_s": window, "kernels": by_name,
            "device_ops": [[n[:160], s] for n, s in ranked[:top]],
            "idle_gaps": [[n[:160], s] for n, s in
                          sorted(idle.items(), key=lambda kv: -kv[1])[:top]]}


def kernel_seconds(prof: dict, *subs: str) -> float:
    """Device seconds of the activities whose name holds any of ``subs``."""
    return sum(s for n, s in prof["kernels"].items()
               if any(x in n for x in subs))


# --------------------------------------------------------------------------
# checks
# --------------------------------------------------------------------------

def relative_gaps(prog: dict, ref: dict, names=None) -> tuple[float, str]:
    """The worst leaf's ``|prog - ref|`` over the larger of the
    reference's value for that leaf and its median leaf's:
    ``(gap, leaf)``."""
    names = sorted(ref if names is None else names)
    med = quantile([ref[n] for n in names], 0.5)
    gaps = {n: abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
            for n in names}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def passed(checks: dict) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checks.values())
