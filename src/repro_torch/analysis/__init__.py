"""shoal-lint on the port: comm-safety analysis of a recorded run (see
README "Static analysis").

:mod:`.trace` records the comm schedule while a program runs (every op
and mailbox call site emits one event while a recorder is active),
:mod:`.rules` runs rules R1-R5 over it, :mod:`.lint` drives both, and
:mod:`.budget` holds an entry's exchange count to
``comm_budgets.toml``.  All produce the shared :class:`.report.Report`
model; :mod:`.registry` names the entry points the CLI
(``scripts/torch_comm_lint.py``) and the tests run them over.

This ``__init__`` stays import-light on purpose:
:mod:`repro_torch.core.ops` imports :mod:`.trace` at module load, so
pulling in the registry (which imports apps and serving) here would be
a cycle.  It resolves lazily via ``__getattr__``, as does the budget.
``analysis.lint`` is the function (the module is
``repro_torch.analysis.lint``'s, imported here first so the name stays
bound to the function).
"""

from repro_torch.analysis.report import (CommLintError, ERROR, Finding,
                                         Report, RULES, WARNING)
from repro_torch.analysis.trace import (CommEvent, Interval, Recorder,
                                        emit, record, scope, waiver)
from repro_torch.analysis.rules import analyze
from repro_torch.analysis.lint import lint, lint_clean, lint_events

__all__ = [
    "CommEvent", "CommLintError", "ERROR", "Finding", "Interval",
    "Recorder", "Report", "RULES", "WARNING", "analyze", "budget", "emit",
    "lint", "lint_clean", "lint_events", "record", "registry", "rules",
    "scope", "trace", "waiver",
]

_LAZY = ("budget", "registry")


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return importlib.import_module(f"{__name__}.{name}")
