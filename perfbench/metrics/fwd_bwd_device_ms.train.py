"""Device milliseconds a training step spends under the program's
``model.forward`` and ``model.backward`` spans (every member's), in the
program-traced pass (``perfbench/program_trace.py``)."""

from perfbench import program_trace


def read(rec):
    return program_trace.span_sum(program_trace.of(rec), "device_ms",
                                  {"model.forward", "model.backward"})
