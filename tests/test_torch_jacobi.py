"""The port's Jacobi application against the JAX package's.

The JAX ``JacobiApp`` runs in one subprocess with 8 emulated CPU
devices (``python tests/test_torch_jacobi.py OUT.npz`` writes its final
grids and states) at n=64, 5 iterations, on 1/2/4/8 kernels, with the
TCP MTU and with a 16-word MTU that splits every halo row into 4
packets, over TCP (acked, halo acks piggybacked) and UDP (async).  The
port runs the same configurations on the CPU.  Grids must agree within
1e-6 (the same float32 operations in the same order: in practice
bit-equal), final states field for field, and the port's exchange count
must follow the wire plan: on TCP 2*iters + 2 on 4 and 8 kernels,
iters + 2 on 2 (the up and down links merge into one group), 0 on 1; on
UDP the same without the 2 drains at the loop exit.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

GRID, ITERS = 64, 5
KERNELS = (1, 2, 4, 8)
MTUS = (9000, 64)
TRANSPORTS = ("tcp", "udp")


def _transport(runtime, name, mtu):
    base = {"tcp": runtime.TCP, "udp": runtime.UDP}[name]
    return dataclasses.replace(base, max_packet_bytes=mtu)


def _grid():
    return np.random.default_rng(5).standard_normal(
        (GRID, GRID)).astype(np.float32)


def _run_reference(out_path):
    import jax.numpy as jnp

    from repro import runtime
    from repro.apps.jacobi import JacobiApp
    from repro.core.address_space import GlobalAddressSpace

    grid, out = _grid(), {}
    for tr in TRANSPORTS:
        for k in KERNELS:
            for mtu in MTUS:
                app = JacobiApp(n=GRID, kernels=k, iters=ITERS,
                                transport=_transport(runtime, tr, mtu))
                st = GlobalAddressSpace(app.ctx).make_global_state()
                st, blocks = app.build()(st, jnp.asarray(
                    grid.reshape(k, GRID // k, GRID)))
                key = f"{tr}/{k}/{mtu}"
                for f in dataclasses.fields(st):
                    out[f"{key}/{f.name}"] = np.asarray(getattr(st, f.name))
                out[f"{key}/grid"] = np.asarray(blocks).reshape(GRID, GRID)
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("jacobi") / "reference.npz"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(repo, "src"))
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           str(path)], env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(path))


def _check_app(reference, transport, kernels, mtu):
    import torch

    from repro_torch import runtime
    from repro_torch.apps.jacobi import JacobiApp, jacobi_reference
    from repro_torch.core.address_space import GlobalAddressSpace
    from repro_torch.core.state import state_to_numpy

    grid = _grid()
    app = JacobiApp(n=GRID, kernels=kernels, iters=ITERS,
                    transport=_transport(runtime, transport, mtu),
                    device="cpu")
    st = GlobalAddressSpace(app.ctx).make_global_state()
    st, blocks = app.run_blocks(st, torch.from_numpy(grid).reshape(
        kernels, GRID // kernels, GRID))
    got = blocks.numpy().reshape(GRID, GRID)
    key = f"{transport}/{kernels}/{mtu}"
    np.testing.assert_allclose(got, reference[f"{key}/grid"], rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(got, jacobi_reference(grid, ITERS, "cpu"),
                               rtol=0, atol=1e-6)
    for f, arr in state_to_numpy(st).items():
        np.testing.assert_array_equal(arr, reference[f"{key}/{f}"],
                                      err_msg=f"{key}: {f}")
    assert not st.credits.any() and not st.error.any()
    drains = 2 if transport == "tcp" else 0
    want = {1: 0, 2: ITERS + drains}.get(kernels, 2 * ITERS + drains)
    assert app.ctx.exchanges == want


@pytest.mark.parametrize("mtu", MTUS)
@pytest.mark.parametrize("kernels", KERNELS)
def test_jacobi_app_matches_reference(reference, kernels, mtu):
    """TCP: acked halos, acks piggybacked on the next iteration."""
    _check_app(reference, "tcp", kernels, mtu)


@pytest.mark.parametrize("mtu", MTUS)
@pytest.mark.parametrize("kernels", KERNELS)
def test_jacobi_app_udp_matches_reference(reference, kernels, mtu):
    """UDP: fire-and-forget halos, no reply and no drain."""
    _check_app(reference, "udp", kernels, mtu)


if __name__ == "__main__":
    _run_reference(sys.argv[1])
