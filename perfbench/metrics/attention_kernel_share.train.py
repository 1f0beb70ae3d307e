"""The share of the program's differentiable attention calls that run on
the training route's kernels, in percent: ``attention.kernel_calls`` over
it and ``attention.plain_calls`` (forward calls), counted in the
program-traced pass (``perfbench/program_trace.py``); none off the card,
where every call takes the plain route by design, nor on a program
without those counters."""

from perfbench import program_trace


def read(rec):
    prog = program_trace.of(rec)
    if prog is None or prog["platform"] != "cuda":
        return None
    c = prog["counters"]
    kernel = c.get("attention.kernel_calls", 0)
    calls = kernel + c.get("attention.plain_calls", 0)
    return 100.0 * kernel / calls if calls else None
