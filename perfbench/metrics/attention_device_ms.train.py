"""Device milliseconds a training step spends under the program's
``model.attention`` spans: the forward, its recomputation and its
backward (``[grad]``), in the program-traced pass
(``perfbench/program_trace.py``)."""

from perfbench import program_trace


def read(rec):
    return program_trace.span_sum(program_trace.of(rec), "device_ms",
                                  {"model.attention"})
