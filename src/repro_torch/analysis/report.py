"""Finding/report model of the port's shoal-lint (the rules and the
exchange budget).

Rule catalog (see README "Static analysis"):

  R1  write-write overlap: two segment writes to overlapping destination
      intervals with no ordering (ack wait / barrier) between them — the
      strided-ingress race class, generalized to any op pair.
  R2  read-after-unordered-write: a get of a segment range with an
      in-flight put (no ``wait_replies`` on the put's token, no barrier)
      overlapping that range.
  R3  credit-flow errors: ``wait_replies`` draining more credits than
      the schedule issued (the trace-time form of the runtime
      ``ERR_WAIT_UNDERFLOW``), credits earned but never consumed
      (leaked acks), and one token fed by several mailboxes with no
      wait between flushes (double-spend hazard).
  R4  addressing errors: statically out-of-bounds destination or source
      intervals (the GAScore clips these silently at runtime), and
      aliasing/duplicate destination addresses inside one vectored
      address list (order-dependent scatter).
  B1  collective-budget violations: an entry point's exchanges exceed
      its declared budget in ``comm_budgets.toml``
      (:mod:`repro_torch.analysis.budget`).
"""

from __future__ import annotations

import dataclasses

ERROR = "error"
WARNING = "warning"

RULES = {
    "R1": "write-write overlap without ordering",
    "R2": "read overlapping an in-flight write",
    "R3": "credit-flow error (underflow / leak / double-spend)",
    "R4": "out-of-bounds or aliasing address list",
    "B1": "collective budget exceeded",
}


@dataclasses.dataclass
class Finding:
    rule: str
    message: str
    severity: str = ERROR
    events: tuple[int, ...] = ()        # seq ids of involved CommEvents
    sites: tuple[str, ...] = ()         # "op#eN" call-site names
    waived: str | None = None           # waiver reason, if annotated

    def render(self) -> str:
        sev = "WAIVED" if self.waived else self.severity.upper()
        at = f" at {', '.join(self.sites)}" if self.sites else ""
        note = f" (waiver: {self.waived})" if self.waived else ""
        return f"[{self.rule}/{sev}]{at}: {self.message}{note}"


@dataclasses.dataclass
class Report:
    """Outcome of linting one entry point (rules and budget)."""

    entry: str
    findings: list[Finding] = dataclasses.field(default_factory=list)
    n_events: int = 0
    tags_recovered: int = 0             # distinct shoal.* tags that
                                        # made an exchange
    wall_time_s: float = 0.0
    budget: dict = dataclasses.field(default_factory=dict)  # pass-2 table row

    @property
    def errors(self) -> list[Finding]:
        return [f for f in self.findings
                if f.severity == ERROR and not f.waived]

    @property
    def warnings(self) -> list[Finding]:
        return [f for f in self.findings
                if f.severity == WARNING and not f.waived]

    @property
    def waived(self) -> list[Finding]:
        return [f for f in self.findings if f.waived]

    @property
    def ok(self) -> bool:
        """Clean = no unwaived findings of any severity."""
        return not self.errors and not self.warnings

    def extend(self, findings) -> "Report":
        self.findings.extend(findings)
        return self

    def render(self) -> str:
        head = (f"shoal-lint {self.entry}: {len(self.errors)} error(s), "
                f"{len(self.warnings)} warning(s), "
                f"{len(self.waived)} waived, {self.n_events} comm event(s)")
        lines = [head]
        lines.extend("  " + f.render() for f in self.findings)
        return "\n".join(lines)


class CommLintError(AssertionError):
    """Raised by ``lint_clean`` when a program has unwaived findings."""

    def __init__(self, report: Report):
        self.report = report
        super().__init__(report.render())
