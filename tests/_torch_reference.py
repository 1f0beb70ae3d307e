"""Running the JAX package on 8 emulated CPU devices for the port's
parity tests.

A parity test file runs itself as a script (``python FILE OUT.npz``) in
one subprocess with ``XLA_FLAGS`` set before JAX is imported, so its
reference cases see 8 devices while the pytest process keeps one.
"""

import os
import subprocess
import sys

import numpy as np

N = 8
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_reference(test_file: str, out_path, timeout: int = 900) -> dict:
    """Run ``test_file`` as a script writing ``out_path``; returns the
    npz's arrays by key."""
    env = dict(os.environ,
               XLA_FLAGS=f"--xla_force_host_platform_device_count={N}",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([os.path.join(REPO, "src"),
                                           os.path.join(REPO, "tests")]))
    proc = subprocess.run([sys.executable, os.path.abspath(test_file),
                           str(out_path)], env=env, capture_output=True,
                          text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(out_path))


def cp_count(compiled) -> int:
    """Collective-permutes in a compiled JAX program's HLO: the wire
    traversals the port's ``ctx.exchanges`` must match."""
    from repro.launch.hlo_analysis import parse_collectives

    return int(parse_collectives(compiled.as_text()).ops.get(
        "collective-permute", 0))


def spmd_run(mesh, fn, state, *extras, compiled=None):
    """Run ``fn(state, *extras) -> (state, outputs)`` per kernel under
    ``shard_map`` on ``mesh`` (every leaf split on its leading kernel
    dim).  Returns ``(state, outputs, collective-permute count,
    compiled program)``; pass the program back as ``compiled`` to run
    it again on new inputs of the same shapes."""
    import jax
    from jax.sharding import PartitionSpec as P

    from repro.runtime.jax_compat import shard_map

    spec = P(("kernel",))

    def inner(st, *xs):
        st = jax.tree.map(lambda x: x[0], st)
        st, outs = fn(st, *(x[0] for x in xs))
        return (jax.tree.map(lambda x: x[None], st),
                tuple(o[None] for o in outs))

    if compiled is None:
        sm = shard_map(inner, mesh=mesh,
                       in_specs=(spec,) * (1 + len(extras)),
                       out_specs=(spec, spec))
        compiled = jax.jit(sm).lower(state, *extras).compile()
    st, outs = compiled(state, *extras)
    return st, outs, cp_count(compiled), compiled
