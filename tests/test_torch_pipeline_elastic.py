"""The port's pipeline parallelism and elastic data parallelism against
the JAX package's, on the CPU.

The JAX references run on 8 emulated CPU devices in one subprocess
(``python tests/test_torch_pipeline_elastic.py OUT.npz``):

* ``pipeline_apply`` on ``tests/md_checks.py:609-633``'s example (4
  tanh layers of width 16 split into 2 stages, 3 microbatches of 5),
  and the same layers in 4 stages: the port's output within 2e-5 of the
  JAX package's and of the sequential reference, its gradient within
  2e-5 of autograd through the sequential version; one exchange per
  tick plus the broadcast's ``2(n - 1)``.
* ``quorum_mean_grads`` over a data axis of 2 (one rank dead, as
  ``tests/md_checks.py:494-504``) and of 4: every kernel's row and the
  live count equal to the JAX package's (1e-6), no exchange counted.

In process: ``delivery_live_mask`` under ``tests/fault_checks.py:145-150``'s
contract -- a reliable put over a ring whose every link drops every
packet exhausts its retries on every kernel, the error words latch
``ERR_RETRY_EXHAUSTED`` and the mask drops every kernel; with only the
link from kernel 3 to 4 lossy, only kernel 3 drops out, and the quorum
mean is the survivors' -- equal to the JAX package's mask on the same
words.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_reference import run_reference  # noqa: E402

from repro_torch.core import handlers as hd, ops  # noqa: E402
from repro_torch.core.faults import FaultModel  # noqa: E402
from repro_torch.core.state import (ERR_RETRY_EXHAUSTED,  # noqa: E402
                                    ShoalContext)
from repro_torch.runtime import LinkClass, LossyTransport  # noqa: E402
from repro_torch.training.elastic import (  # noqa: E402
    FailureInjector, delivery_live_mask, quorum_mean_grads)
from repro_torch.training.pipeline import (  # noqa: E402
    pipeline_apply, split_stages)

L, D, M, MB = 4, 16, 3, 5
STAGES = (2, 4)
QUORUM = {2: [1.0, 0.0], 4: [1.0, 0.0, 1.0, 1.0]}
N, PAY, MTU = 8, 16, 16      # fault_checks.py: a 16-word put, 4 segments


def _pipe_inputs():
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((L, D, D)) * 0.3).astype(np.float32)
    xs = rng.standard_normal((M, MB, D)).astype(np.float32)
    return w, xs


def _grads_in(n):
    rng = np.random.default_rng(10 + n)
    return rng.standard_normal((n, 3, 5)).astype(np.float32)


# -- the reference ------------------------------------------------------------

def _run_reference(out_path):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.runtime.jax_compat import make_mesh, shard_map
    from repro.training.elastic import quorum_mean_grads as jquorum
    from repro.training.pipeline import pipeline_apply as jpipe
    from repro.training.pipeline import split_stages as jsplit

    w, xs = _pipe_inputs()

    def stage_fn(pslice, x):
        def body(x, wl):
            return jnp.tanh(x @ wl), ()
        x, _ = jax.lax.scan(body, x, pslice["w"])
        return x

    out = {}
    for n in STAGES:
        mesh = make_mesh((n, 8 // n), ("pod", "chip"))
        out[f"pipe/{n}"] = np.asarray(jax.jit(lambda p, x: jpipe(
            mesh, "pod", stage_fn, p, x))(jsplit({"w": jnp.asarray(w)}, n),
                                          jnp.asarray(xs)))
    for n, live in QUORUM.items():
        mesh = make_mesh((n, 8 // n), ("data", "model"))

        def qfn(g, lv):
            got, n_live = jquorum({"g": g[0]}, lv[0], ("data",))
            return got["g"][None], n_live[None]

        g, n_live = jax.jit(shard_map(
            qfn, mesh=mesh, in_specs=(P("data"), P("data")),
            out_specs=(P("data"), P("data"))))(
            jnp.asarray(_grads_in(n)), jnp.asarray(live, jnp.float32))
        out[f"quorum/{n}/g"] = np.asarray(g)
        out[f"quorum/{n}/n_live"] = np.asarray(n_live)
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(__file__,
                         tmp_path_factory.mktemp("pipe") / "ref.npz")


# -- pipeline ------------------------------------------------------------------

def _stage_fn(p, x):
    for layer in range(p["w"].shape[0]):
        x = torch.tanh(x @ p["w"][layer])
    return x


@pytest.mark.parametrize("n", STAGES)
def test_pipeline_apply_matches_jax_and_the_sequential_model(reference, n):
    w_np, xs_np = _pipe_inputs()
    w = torch.from_numpy(w_np).requires_grad_()
    xs = torch.from_numpy(xs_np)
    ctx = ShoalContext(n, device="cpu")
    out = pipeline_apply(ctx, _stage_fn, split_stages({"w": w}, n), xs)
    assert ctx.exchanges == (M + n - 1) + 2 * (n - 1)
    ref = xs
    for layer in range(L):
        ref = torch.tanh(ref @ w[layer])
    np.testing.assert_allclose(out.detach().numpy(), reference[f"pipe/{n}"],
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(),
                               rtol=2e-5, atol=2e-5)
    # the backward schedule: autograd through the ticks and handoffs
    probe = torch.from_numpy(np.random.default_rng(1).standard_normal(
        xs_np.shape).astype(np.float32))
    got, = torch.autograd.grad((out * probe).sum(), w)
    want, = torch.autograd.grad((ref * probe).sum(), w)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5,
                               atol=2e-5)


def test_split_stages_refuses_an_uneven_split():
    stacked = split_stages({"w": torch.zeros(4, 2, 2)}, 2)
    assert stacked["w"].shape == (2, 2, 2, 2)
    with pytest.raises(ValueError, match="3 stages"):
        split_stages({"w": torch.zeros(4, 2, 2)}, 3)


# -- quorum and delivery failure -------------------------------------------------

@pytest.mark.parametrize("n", sorted(QUORUM))
def test_quorum_mean_grads_matches_jax(reference, n):
    ctx = ShoalContext(n, device="cpu")
    live = torch.tensor(QUORUM[n])
    g = torch.from_numpy(_grads_in(n))
    got, n_live = quorum_mean_grads(ctx, {"g": g}, live)
    np.testing.assert_allclose(got["g"].numpy(), reference[f"quorum/{n}/g"],
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(n_live.numpy(),
                                  reference[f"quorum/{n}/n_live"])
    survivors = g[live > 0].mean(0)
    for k in range(n):
        np.testing.assert_allclose(got["g"][k].numpy(), survivors.numpy(),
                                   rtol=1e-6, atol=1e-6)
    assert ctx.exchanges == 0


def _exhausting_put(device, lossy_from=None):
    """``tests/fault_checks.py``'s 16-word ring put (4 segments) over
    links that drop every packet: all of them, or only the link between
    kernel ``lossy_from`` and its ring successor (both ways: the put and
    its ack)."""
    pair = None if lossy_from is None else {lossy_from, (lossy_from + 1) % N}
    link_of = (lambda s, d: LinkClass.LOCAL if s == d else LinkClass.DCN) \
        if pair is None else \
        (lambda s, d: LinkClass.DCN if {s, d} == pair else LinkClass.ICI)
    ctx = ShoalContext(N, LossyTransport(faults=FaultModel(drop=1.0, seed=0),
                                         max_packet_bytes=MTU,
                                         link_of=link_of), 64, device=device)
    ring = [(i, (i + 1) % N) for i in range(N)]
    pay = (torch.arange(PAY, dtype=torch.float32, device=device) + 1) \
        * (torch.arange(N, device=device)[:, None] + 1)
    st = ops.put_long(ctx, ctx.make_state(), pay, ring, dst_addr=10, token=1,
                      handler=hd.H_WRITE)
    return ops.wait_replies(ctx, st, 1, 1, timeout=True)


@pytest.mark.parametrize("lossy_from", [None, 3])
def test_delivery_live_mask_drops_exhausted_kernels(lossy_from):
    from repro.training.elastic import delivery_live_mask as jmask

    st = _exhausting_put("cpu", lossy_from)
    err = st.error
    dead = list(range(N)) if lossy_from is None else [lossy_from]
    assert [k for k in range(N) if err[k] & ERR_RETRY_EXHAUSTED] == dead
    live = delivery_live_mask(torch.ones(N), err)
    assert live.tolist() == [0.0 if k in dead else 1.0 for k in range(N)]
    np.testing.assert_array_equal(
        live.numpy(), np.asarray(jmask(np.ones(N, np.float32), err.numpy())))
    # a clean kernel stays live; a wider mask drops on other bits too
    assert float(delivery_live_mask(torch.tensor(1.0),
                                    torch.tensor(0))) == 1.0
    assert float(delivery_live_mask(torch.tensor(1.0), torch.tensor(2),
                                    bits=3)) == 0.0
    if lossy_from is not None:     # the survivors' mean, renormalized
        g = torch.arange(N * 2, dtype=torch.float32).reshape(N, 2)
        mean, n_live = quorum_mean_grads(ShoalContext(N, device="cpu"),
                                         [g], live)
        assert float(n_live[0]) == N - 1
        want = g[[k for k in range(N) if k != lossy_from]].mean(0)
        assert torch.allclose(mean[0][5], want)


def test_failure_injector_fires_once_per_step():
    inj = FailureInjector({2, 5})
    inj.check(1)
    with pytest.raises(RuntimeError, match="step 2"):
        inj.check(2)
    inj.check(2)
    with pytest.raises(RuntimeError, match="step 5"):
        inj.check(5)


if __name__ == "__main__":
    _run_reference(sys.argv[1])
