"""Run a cell of the benchmark at ``<root>`` on the CPU, as ``run.py``
runs it but without looking for a card, with a fault of
``perfbench/faults.py`` planted first (``-`` for none; ``module:<name>``
puts an empty module of that name in ``sys.modules``):

    python cpu_run.py <root> <fault|-> --workload <cell> --seed <n> ...
"""

import sys
import types

root, fault, argv = sys.argv[1], sys.argv[2], sys.argv[3:]
sys.path.insert(0, root)

from perfbench import faults, run  # noqa: E402

if fault.startswith("module:"):
    name = fault.split(":", 1)[1]
    sys.modules[name] = types.ModuleType(name)
elif fault != "-":
    faults.plant(fault)
sys.exit(run.main(argv, device="cpu"))
