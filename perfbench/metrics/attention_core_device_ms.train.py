"""Device milliseconds a training step spends under the program's
``attention.core`` spans -- the attend call alone, without the q / k /
v / o products and rope around it -- in the forward, its recomputation
and its backward (``[grad]``), in the program-traced pass
(``perfbench/program_trace.py``); none on a program without the span."""

from perfbench import program_trace


def read(rec):
    return program_trace.span_sum(program_trace.of(rec), "device_ms",
                                  {"attention.core"})
