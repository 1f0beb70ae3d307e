"""Host syncs a training step makes inside the program's ``train.step``
span: the stream, device and event synchronisations and the copies that
block the host, one per operation that makes them, in the
program-traced pass (``perfbench/program_trace.py``); none off the
card."""

from perfbench import program_trace


def read(rec):
    prog = program_trace.of(rec)
    if prog is None or prog["platform"] != "cuda":
        return None
    return prog["host_syncs_per_step"]
