"""The exchange budget of the port's shoal-lint (rule B1).

The declared side is the repo's ``comm_budgets.toml``, read-only: one
``[section]`` per budgeted program, keys ``<metric>_max`` /
``<metric>_exact``.  The measured side is what the port counts: an
entry's ``collective_permute`` is its run's ``ctx.exchanges`` delta,
the count of kernel-axis gathers, the port's collective-permutes; its
``all_to_all``, ``all_reduce``, ``all_gather`` and ``reduce_scatter``
are its run's ``ctx.collectives`` deltas, one per collective call, and
``total_collectives`` their sum.  The run is eager, so the counts are
dynamic: a loop's calls count once per iteration, with no trip-count
weighting.

The port models no wire bytes: a budget key on ``wire_bytes`` gets a
WARNING finding that names it as not measured -- never a silent pass.

Violations become rule-B1 findings in the same report model as the
rules, naming the op sites whose exchanges the run counted.  A
budgeted program with *no* section is a B1 warning: budgets must stay
checked in, or regressions land silently.

The TOML parser handles the subset the budget file uses (sections,
numeric/string/bool values, comments); anything it cannot parse is a
hard error, not a guess.
"""

from __future__ import annotations

import os

from repro_torch.analysis.report import ERROR, WARNING, Finding
from repro_torch.core.state import COLLECTIVE_KINDS

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))
DEFAULT_BUDGETS_PATH = os.path.join(_REPO_ROOT, "comm_budgets.toml")

# budget-key metrics the port measures
MEASURED = ("collective_permute",) + COLLECTIVE_KINDS + ("total_collectives",)
# the rest of comm_budgets.toml's metrics: ring-model bytes the port does
# not count
NOT_MEASURED = ("wire_bytes",)


def parse_budget_toml(text: str) -> dict[str, dict]:
    """Parse the comm_budgets.toml subset: [sections] of key = value."""
    out: dict[str, dict] = {}
    cur: dict | None = None
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        if line.startswith("[") and line.endswith("]"):
            name = line[1:-1].strip().strip('"')
            cur = out.setdefault(name, {})
            continue
        if "=" not in line or cur is None:
            raise ValueError(
                f"comm_budgets.toml line {lineno}: cannot parse {raw!r}")
        key, val = (s.strip() for s in line.split("=", 1))
        if val.startswith('"') and val.endswith('"'):
            cur[key] = val[1:-1]
        elif val in ("true", "false"):
            cur[key] = val == "true"
        else:
            try:
                num = float(val)
            except ValueError:
                raise ValueError(
                    f"comm_budgets.toml line {lineno}: bad value {val!r}")
            cur[key] = int(num) if num.is_integer() and "." not in val \
                and "e" not in val.lower() else num
    return out


def load_budgets(path: str | None = None) -> dict[str, dict]:
    with open(path or DEFAULT_BUDGETS_PATH) as f:
        return parse_budget_toml(f.read())


def measure(exchanges: int,
            collectives: dict[str, int] | None = None) -> dict[str, float]:
    """The measured metrics of one entry's run: its exchanges and its
    collective calls by kind (none when omitted)."""
    calls = {kind: float((collectives or {}).get(kind, 0))
             for kind in COLLECTIVE_KINDS}
    return {"collective_permute": float(exchanges), **calls,
            "total_collectives": sum(calls.values())}


def _sites(tags: dict[str, int]) -> tuple[str, ...]:
    return tuple(t[len("shoal."):] for t in tags)


def check_budget(entry: str, measured: dict[str, float], spec: dict | None,
                 tags: dict[str, int] | None = None) -> list[Finding]:
    """Diff measured metrics against one budget section; B1 findings.
    ``tags`` (``{tag: exchanges}`` of the run) names the op sites a
    finding's exchanges came from."""
    if not spec:
        return [Finding(
            rule="B1", severity=WARNING,
            message=(f"no [{entry}] section in comm_budgets.toml — "
                     "declare a collective budget so wire-cost "
                     "regressions in this program are caught"))]
    tags = tags or {}
    out: list[Finding] = []
    for key, want in spec.items():
        if isinstance(want, str):            # note/doc keys
            continue
        if key.endswith("_max"):
            base, exact = key[:-4], False
        elif key.endswith("_exact"):
            base, exact = key[:-6], True
        else:
            raise ValueError(
                f"comm_budgets.toml [{entry}]: unknown key {key!r} "
                "(want <metric>_max or <metric>_exact)")
        if base in NOT_MEASURED:
            out.append(Finding(
                rule="B1", severity=WARNING,
                message=(f"{entry}: {key} = {want:g} is not measured — the "
                         f"port counts exchanges and collective calls, "
                         f"not {base.replace('_', '-')}")))
            continue
        if base not in MEASURED:
            raise ValueError(
                f"comm_budgets.toml [{entry}]: unknown metric {base!r}")
        got = measured[base]
        bad = (abs(got - want) > 1e-6) if exact else (got > want + 1e-6)
        if bad:
            rel = "!=" if exact else ">"
            by_op = ", ".join(f"{t}: {n}" for t, n in tags.items())
            what = ("exchange count" if base == "collective_permute"
                    else "collective calls")
            out.append(Finding(
                rule="B1", severity=ERROR, sites=_sites(tags),
                message=(f"{entry}: measured {base.replace('_', '-')} "
                         f"{got:g} {rel} declared budget {want:g} — the "
                         f"program's {what} drifted from "
                         f"comm_budgets.toml [{entry}] (exchanges by op: "
                         f"{by_op or 'none attributed'})")))
    return out


def budget_row(measured: dict[str, float], spec: dict | None,
               tags: dict[str, int] | None = None) -> dict:
    """JSON-ready table row: measured counts (exchanges, and each
    collective kind the run called), the exchanges by op tag, and the
    declared budget."""
    ops = {"collective-permute": measured["collective_permute"]}
    ops.update({kind.replace("_", "-"): measured[kind]
                for kind in COLLECTIVE_KINDS if measured[kind]})
    return {
        "ops": ops,
        "by_tag": dict(tags or {}),
        "budget": dict(spec or {}),
    }
