"""The share of the MoE dispatch's expert slots that hold a routed pair,
in percent: the program's kept pairs over the slots it computes
(``moe.kept_pairs`` / ``moe.slots``, forward calls only), counted in the
program-traced pass (``perfbench/program_trace.py``)."""

from perfbench import program_trace


def read(rec):
    prog = program_trace.of(rec)
    if prog is None or not prog["counters"].get("moe.slots"):
        return None
    c = prog["counters"]
    return 100.0 * c["moe.kept_pairs"] / c["moe.slots"]
