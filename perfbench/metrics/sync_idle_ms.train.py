"""Milliseconds a training step leaves the device idle in gaps that open
under the program's ``train.sync`` span, in the program-traced pass
(``perfbench/program_trace.py``)."""

from perfbench import program_trace


def read(rec):
    return program_trace.span_sum(program_trace.of(rec), "idle_ms",
                                  {"train.sync"})
