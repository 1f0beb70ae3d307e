"""The port's shoal-lint front end: run a program once under a recorder,
lint its comm schedule.

``lint(fn, *args)`` runs ``fn(*args)`` once, eagerly, under a fresh
event recorder (:mod:`repro_torch.analysis.trace`) on the device its
arguments live on, and runs rules R1-R5 over the recorded schedule.
There is no trace cache to step around: the program is its execution.
An exchange counted with no event recorded is an infrastructure error
(an op without its hook), not a clean report.
"""

from __future__ import annotations

import dataclasses
import time

from repro_torch.analysis import rules, trace
from repro_torch.analysis.report import CommLintError, Report


def record_run(fn, *args):
    """Run ``fn(*args)`` once under a fresh recorder; returns
    ``(result, recorder)``."""
    with trace.record() as rec:
        out = fn(*args)
    return out, rec


def report_of(rec: trace.Recorder, name: str) -> Report:
    """Rules R1-R5 over one recorded run."""
    if rec.exchanges and not rec.events:
        raise RuntimeError(
            f"shoal-lint {name}: {rec.exchanges} exchange(s) were counted "
            "but no event was recorded -- an op of the run has no "
            "emit/scope hook.")
    tags = trace.recover_tags(rec)
    rep = Report(entry=name, n_events=len(rec.events),
                 tags_recovered=len(tags))
    return rep.extend(rules.analyze(rec.events))


def lint(fn, *args, name: str | None = None) -> Report:
    """Run ``fn(*args)`` once, record its comm schedule, run rules R1-R5.

    Returns a :class:`Report`; raising on findings is
    :func:`lint_clean`'s job.
    """
    if name is None:
        name = getattr(fn, "__name__", None) or repr(fn)
    t0 = time.perf_counter()
    _, rec = record_run(fn, *args)
    rep = report_of(rec, name)
    rep.wall_time_s = time.perf_counter() - t0
    return rep


def lint_events(events, name: str = "<schedule>") -> Report:
    """Lint an explicit event schedule (no run) -- the entry point for
    synthetic/fuzzed schedules in tests."""
    rep = Report(entry=name, n_events=len(events))
    return rep.extend(rules.analyze(list(events)))


def lint_clean(fn, *args, name: str | None = None) -> Report:
    """Assert ``fn`` has no unwaived findings; the pytest-facing form.

    Raises :class:`CommLintError` (an AssertionError) rendering every
    finding when the program is not clean; returns the report otherwise.
    """
    rep = lint(fn, *args, name=name)
    if not rep.ok:
        raise CommLintError(rep)
    return rep


def events_json(events) -> list[dict]:
    """JSON-ready records of an event list, for comparing two runs of
    one program: every field, intervals as ``[start, words]`` pairs and
    mailbox ids renumbered in order of first appearance."""
    ids: dict[int, int] = {}
    out = []
    for ev in events:
        d = dataclasses.asdict(ev)
        for key in ("writes", "reads"):
            d[key] = [[iv["start"], iv["words"]] for iv in d[key]]
        d["pattern"] = [list(p) for p in d["pattern"]]
        d["credit_grants"] = [list(g) for g in d["credit_grants"]]
        if d["mailbox_id"] is not None:
            d["mailbox_id"] = ids.setdefault(d["mailbox_id"], len(ids))
        out.append(d)
    return out
