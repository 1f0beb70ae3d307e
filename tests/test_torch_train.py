"""The port's data-parallel trainer against the JAX package's, on the CPU.

tinyllama-smoke (``configs.reduced("tinyllama-1.1b")``: 2 layers,
d_model 64, float32) with the JAX package's ``Model.init`` weights
carried across by ``models.convert.params_from_numpy``; batches from
``TokenPipeline`` (bitwise the same in both packages).

In process, JAX on one device:

* ``Model.loss`` and its gradient against ``jax.value_and_grad(loss)``:
  loss 1e-5, every gradient leaf within a relative 1e-4 of the largest
  |gradient| of the leaf (the same float32 operations, in other
  orders); ``loss`` attends through ``_attend``, never the flash kernel.
* One and two ``xla``-backend steps against the JAX ``Trainer`` without
  a mesh: parameters and m / v 1e-5.
* Microbatches: the port's n = 2 / 4 against its own n = 1 and against
  the JAX trainer's n = 2: 1e-5.
* The ``shoal`` step at K = 2 and 4 against the port's own ``xla``
  step: loss and parameters 1e-5.

The JAX ``shoal`` trainer runs on 8 emulated CPU devices in one
subprocess (``python tests/test_torch_train.py OUT.npz``), on meshes of
``("data", "model")`` = (2, 4) and (4, 2), as ``tests/md_checks.py:458``
builds them: the port's shoal step with K = 2 and 4 against it, loss and
parameters 1e-4 (``tests/md_checks.py:479-482``'s bounds), compressed
5e-2 (``:485-490``); before that, the synced gradients the update is
given (recovered from the JAX step's first AdamW moment): plain 1e-5
of each leaf's largest value, compressed one quantization step, and
the error-feedback residual; ``ctx.exchanges`` per step equals the
compiled JAX step's collective-permute count (12 leaves x 2(K - 1),
twice that compressed).
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_reference import run_reference  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.data import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.training import Trainer, TrainerConfig  # noqa: E402
from repro_torch.tree import tree_paths  # noqa: E402

ARCH = "tinyllama-1.1b"
BATCH, SEQ, DATA_SEED = 8, 16, 1
LR = 1e-3
KS = (2, 4)
LEAVES = 12                   # tinyllama's parameter leaves


def batch_np(step=0, batch=BATCH, seq=SEQ, seed=DATA_SEED, vocab=512):
    return TokenPipeline(DataConfig(vocab=vocab, batch=batch, seq=seq,
                                    seed=seed), device="cpu").batch_at(step)


def to_port(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


def port_arrays(tree) -> dict:
    """``{path: float64 / int array}`` of a port tree."""
    return {p: leaf.detach().cpu().double().numpy()
            if leaf.dtype.is_floating_point else leaf.cpu().numpy()
            for p, leaf in tree_paths(tree)}


def jax_arrays(tree) -> dict:
    """The same of a JAX tree, by the JAX checkpoint's path names."""
    import jax

    from repro.checkpoint.checkpoint import _tree_paths

    names, leaves, _ = _tree_paths(jax.device_get(tree))
    return {n: np.asarray(x, np.float64)
            if np.issubdtype(np.asarray(x).dtype, np.floating)
            else np.asarray(x) for n, x in zip(names, leaves)}


def assert_trees_close(got: dict, want: dict, tol: float):
    assert got.keys() == want.keys()
    for path in want:
        np.testing.assert_allclose(got[path], want[path], rtol=tol, atol=tol,
                                   err_msg=path)


def port_trainer(tcfg=TrainerConfig(), kernels=1, lr=LR):
    cfg = configs.reduced(ARCH)
    return Trainer(build_model(cfg, device="cpu"), AdamWConfig(lr=lr), tcfg,
                   kernels=kernels)


def port_state(trainer, params_np):
    return trainer.state_for(params_from_numpy(trainer.model.cfg, params_np,
                                               device="cpu"))


# -- the reference ------------------------------------------------------------

def _run_reference(out_path):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from _torch_reference import cp_count
    from repro import configs as jconfigs
    from repro.models.model import build_model as jbuild
    from repro.optim.adamw import AdamWConfig as JAdamW
    from repro.runtime.jax_compat import make_mesh
    from repro.training.train import Trainer as JTrainer
    from repro.training.train import TrainerConfig as JConfig

    cfg = jconfigs.reduced(ARCH)
    batch = batch_np()
    out = {}
    for K in KS:
        mesh = make_mesh((K, 8 // K), ("data", "model"))
        b = {k: jax.device_put(v, NamedSharding(mesh, P(("data",))))
             for k, v in batch.items()}
        model = jbuild(cfg, mesh=mesh, dp_axes=())
        for comp in (False, True):
            tr = JTrainer(model, JAdamW(lr=LR),
                          JConfig(comm_backend="shoal", grad_compression=comp,
                                  donate=False), dp_axes=("data",))
            st = tr.init_state(jax.random.PRNGKey(0))
            compiled = tr.make_train_step().lower(st, b).compile()
            new, met = compiled(st, b)
            tag = f"K{K}/{'int8' if comp else 'f32'}"
            out[f"{tag}/loss"] = np.asarray(met["loss"])
            out[f"{tag}/grad_norm"] = np.asarray(met["grad_norm"])
            out[f"{tag}/cps"] = np.asarray(cp_count(compiled))
            for path, arr in jax_arrays(new.params).items():
                out[f"{tag}/params/{path}"] = arr
            for path, arr in jax_arrays(new.opt_state["m"]).items():
                out[f"{tag}/m/{path}"] = arr
            if comp:
                for path, arr in jax_arrays(new.ef_residual).items():
                    out[f"{tag}/res/{path}"] = arr
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(__file__,
                         tmp_path_factory.mktemp("train") / "ref.npz")


# -- the model's loss ----------------------------------------------------------

@pytest.fixture(scope="module")
def jax_side():
    import jax

    from repro import configs as jconfigs
    from repro.models.model import build_model as jbuild

    jm = jbuild(jconfigs.reduced(ARCH))
    params = jm.init(jax.random.PRNGKey(0))
    return jm, params, jax.device_get(params)


def test_model_loss_and_gradient_match_jax(jax_side, monkeypatch):
    import jax
    import jax.numpy as jnp

    jm, jparams, params_np = jax_side
    batch = batch_np()
    jloss, jgrads = jax.value_and_grad(jm.loss)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    flash = []
    real = tattn.flash_attention
    monkeypatch.setattr(tattn, "flash_attention",
                        lambda *a: flash.append(1) or real(*a))
    trainer = port_trainer()
    params = params_from_numpy(trainer.model.cfg, params_np, device="cpu")
    loss, grads = trainer.value_and_grad(params, to_port(batch))
    assert not flash, "Model.loss took the forward-only flash route"
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5,
                               atol=1e-5)
    got, want = port_arrays(grads), jax_arrays(jgrads)
    assert got.keys() == want.keys() and len(got) == LEAVES
    for path in want:
        scale = np.abs(want[path]).max()
        np.testing.assert_allclose(got[path], want[path], rtol=0,
                                   atol=1e-4 * scale, err_msg=path)


# -- the xla backend -------------------------------------------------------------

def _jax_trainer_steps(params_np, steps, microbatches=1):
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.models.model import build_model as jbuild
    from repro.optim.adamw import AdamWConfig as JAdamW
    from repro.training.train import Trainer as JTrainer
    from repro.training.train import TrainerConfig as JConfig

    tr = JTrainer(jbuild(jconfigs.reduced(ARCH)), JAdamW(lr=LR),
                  JConfig(microbatches=microbatches, donate=False))
    st = tr.init_state(jax.random.PRNGKey(0))
    st.params = jax.tree.map(jnp.asarray, params_np)
    fn = tr.make_train_step()
    losses = []
    for s in range(steps):
        st, met = fn(st, {k: jnp.asarray(v) for k, v in batch_np(s).items()})
        losses.append(float(met["loss"]))
    return st, losses


def _port_steps(trainer, params_np, steps):
    st = port_state(trainer, params_np)
    losses = []
    for s in range(steps):
        st, met = trainer.step(st, to_port(batch_np(s)))
        losses.append(float(met["loss"]))
    return st, losses


@pytest.mark.parametrize("steps", [1, 2])
def test_xla_steps_match_the_jax_trainer(jax_side, steps):
    params_np = jax_side[2]
    jst, jlosses = _jax_trainer_steps(params_np, steps)
    st, losses = _port_steps(port_trainer(), params_np, steps)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5, atol=1e-5)
    assert int(st.step) == steps == int(jst.step)
    assert_trees_close(port_arrays(st.params), jax_arrays(jst.params), 1e-5)
    assert_trees_close(port_arrays(st.opt_state), jax_arrays(jst.opt_state),
                       1e-5)


@pytest.mark.parametrize("n", [2, 4])
def test_microbatches_match_one_batch_and_jax(jax_side, n):
    params_np = jax_side[2]
    one, _ = _port_steps(port_trainer(), params_np, 1)
    many, _ = _port_steps(port_trainer(TrainerConfig(microbatches=n)),
                          params_np, 1)
    assert_trees_close(port_arrays(many.params), port_arrays(one.params),
                       1e-5)
    if n == 2:
        jst, _ = _jax_trainer_steps(params_np, 1, microbatches=n)
        assert_trees_close(port_arrays(many.params), jax_arrays(jst.params),
                           1e-5)
    with pytest.raises(ValueError, match="microbatches"):
        port_trainer(TrainerConfig(microbatches=3)).step(
            port_state(port_trainer(), params_np), to_port(batch_np()))


# -- the shoal backend -------------------------------------------------------------

@pytest.mark.parametrize("K", KS)
def test_shoal_step_matches_the_xla_step(jax_side, K):
    params_np = jax_side[2]
    xla, xla_losses = _port_steps(port_trainer(), params_np, 2)
    trainer = port_trainer(TrainerConfig(comm_backend="shoal"), kernels=K)
    shoal, losses = _port_steps(trainer, params_np, 2)
    np.testing.assert_allclose(losses, xla_losses, rtol=1e-5, atol=1e-5)
    assert_trees_close(port_arrays(shoal.params), port_arrays(xla.params),
                       1e-5)
    assert trainer.ctx.exchanges == 2 * LEAVES * 2 * (K - 1)


def _jax_synced_grads(reference, tag) -> dict:
    """The JAX shoal step's synced gradients, by path, from its first
    AdamW moment: ``m = (1 - b1) * clip * g`` after one step from zero,
    ``clip = min(1, grad_clip / |g|)`` of the step's ``grad_norm``."""
    opt = AdamWConfig()
    gn = float(reference[f"{tag}/grad_norm"])
    clip = min(1.0, opt.grad_clip / max(gn, 1e-12))
    head = f"{tag}/m/"
    return {p[len(head):]: m / ((1 - opt.b1) * clip)
            for p, m in reference.items() if p.startswith(head)}


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("comp", [False, True])
def test_shoal_step_matches_the_jax_shoal_trainer(reference, jax_side, K,
                                                  comp):
    """The synced gradients ``Trainer.grads`` hands the update against
    JAX's: plain within 1e-5 of each leaf's largest |gradient|;
    compressed within one quantization step of the synced sum (the
    members' mean int8 scale over K: a payload that rounds the other
    way in one member), and each member's error-feedback residual within
    half its own step, member 0's against the JAX step's.  Then the
    parameters after the update: 1e-4, compressed 5e-2."""
    tag = f"K{K}/{'int8' if comp else 'f32'}"
    trainer = port_trainer(TrainerConfig(comm_backend="shoal",
                                         grad_compression=comp), kernels=K)
    st = port_state(trainer, jax_side[2])
    batch = to_port(batch_np())
    loss, grads, res = trainer.grads(st, batch)
    assert abs(float(loss) - float(reference[f"{tag}/loss"])) < 1e-4
    assert trainer.ctx.exchanges == int(reference[f"{tag}/cps"]) \
        == LEAVES * 2 * (K - 1) * (2 if comp else 1)
    want_g, got_g = _jax_synced_grads(reference, tag), port_arrays(grads)
    assert got_g.keys() == want_g.keys() and len(got_g) == LEAVES
    steps = {}
    if comp:          # each member's int8 scale, max |g_k| / 127 (no
        #               residual before the first step)
        per_member = [dict(tree_paths(g)) for _, g in
                      trainer.member_grads(st.params, batch)]
        steps = {p: np.array([max(float(m[p].abs().max()), 1e-12) / 127
                              for m in per_member]) for p in want_g}
        want_r = {p[len(f"{tag}/res/"):]: v for p, v in reference.items()
                  if p.startswith(f"{tag}/res/")}
        got_r = port_arrays(res)
        assert got_r.keys() == want_r.keys()
    for path, want in want_g.items():
        tol = 1e-5 * np.abs(want).max()
        if comp:
            tol += steps[path].mean() / K
        np.testing.assert_allclose(got_g[path], want, rtol=0, atol=tol,
                                   err_msg=path)
        if comp:
            r, s = got_r[path], steps[path]
            assert r.shape == (K,) + want.shape
            for k in range(K):
                assert np.abs(r[k]).max() <= s[k] * (0.5 + 1e-4), (path, k)
            # member 0's residual is the JAX step's (its out_specs P()
            # keeps the first member's); where a payload rounded the
            # other way the two differ by one step
            d = np.abs(r[0] - want_r[path])
            assert d.max() <= s[0] * (1 + 1e-3), path
            assert (d > 1e-3 * s[0]).sum() <= 1 + 1e-3 * d.size, path

    new, _ = trainer.apply_update(st, grads, loss, res)
    tol = 5e-2 if comp else 1e-4
    head = f"{tag}/params/"
    want = {p[len(head):]: v for p, v in reference.items()
            if p.startswith(head)}
    got = port_arrays(new.params)
    assert got.keys() == want.keys()
    for path in want:
        assert np.abs(got[path] - want[path]).max() < tol, path


def test_shoal_sync_sends_every_leaf_through_the_ring(jax_side, monkeypatch):
    """One ``ring_all_reduce`` per leaf (two compressed: the int32
    payload and the (K, 1) scale); every reduced row equal bitwise; the
    int32 sum exact."""
    from repro_torch.core import collectives as coll

    calls = []
    real = coll.ring_all_reduce

    def spy(ctx, x):
        out = real(ctx, x)
        calls.append((x.clone(), out))
        return out

    monkeypatch.setattr(coll, "ring_all_reduce", spy)
    for comp in (False, True):
        calls.clear()
        trainer = port_trainer(TrainerConfig(comm_backend="shoal",
                                             grad_compression=comp),
                               kernels=4)
        trainer.step(port_state(trainer, jax_side[2]), to_port(batch_np()))
        assert len(calls) == LEAVES * (2 if comp else 1)
        for x, out in calls:
            assert torch.equal(out, out[:1].expand_as(out))
            if x.dtype == torch.int32:
                assert torch.equal(out[0], x.sum(0, dtype=torch.int64).int())
        dtypes = [x.dtype for x, _ in calls]
        assert dtypes == ([torch.int32, torch.float32] * LEAVES if comp
                          else [torch.float32] * LEAVES)


def test_trainer_refuses_what_it_does_not_run():
    with pytest.raises(ValueError, match="comm_backend"):
        port_trainer(TrainerConfig(comm_backend="gspmd"))
    with pytest.raises(ValueError, match="shoal"):
        port_trainer(TrainerConfig(grad_compression=True))
    trainer = port_trainer(TrainerConfig(comm_backend="shoal"), kernels=3)
    st = trainer.init_state(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="3 data-parallel members"):
        trainer.step(st, to_port(batch_np()))


if __name__ == "__main__":
    _run_reference(sys.argv[1])
