"""The port's checkpoints and the launcher's fault tolerance, on the CPU
(the ports of ``tests/test_checkpoint_training.py``), plus the JAX
package's on-disk format read back.

* Save and restore bitwise, a bfloat16 leaf included (its bits under a
  ``'<V2'`` header, ``"dtype": "bfloat16"``); a corrupted leaf raises
  ``ChecksumError``; async saves and garbage collection; no partial
  checkpoint listed.
* A tree of bfloat16 and float32 leaves saved by the port and by the JAX
  package gives the same step directory, file for file (leaf bytes and
  manifest, sha256 included); the port restores its own bfloat16 file
  and an older ``<u2`` one bit for bit.
* A trainer that fails at step 4 and restores from its last checkpoint
  ends with the uninterrupted run's losses and parameters (1e-6), in the
  loop and through ``launch.train --fail-at 4``.
* A checkpoint the JAX package wrote for its float32 trainer restores
  into the port's trainer by tree path (every leaf bitwise), and the
  port's next step equals the JAX trainer's next step (1e-5).
* A checkpoint saved by a ``shoal`` trainer of K = 4 restores into one of
  K = 2 and trains on, equal to the K = 4 trainer's next step (1e-5).
"""

import json
import os

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointManager, ChecksumError
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.launch import train as launch_train
from repro_torch.training import TrainerConfig
from repro_torch.training.elastic import FailureInjector
from repro_torch.tree import tree_paths
from test_torch_train import (assert_trees_close, batch_np, jax_arrays,
                              port_arrays, port_trainer, to_port)


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def test_save_restore_bitwise_with_a_bfloat16_leaf(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.tensor([1, 2, 3], dtype=torch.int32),
                  "h": torch.randn(5, 7).to(torch.bfloat16)},
            "n": [torch.tensor(7, dtype=torch.int32)]}
    mgr.save(5, tree, extras={"data_step": 5})
    with open(tmp_path / "step_00000005" / "manifest.json") as f:
        manifest = json.load(f)
    entries = {e["path"]: e for e in manifest["leaves"]}
    assert list(entries) == ["a", "b/c", "b/h", "n/0"]
    assert entries["b/h"]["dtype"] == "bfloat16"
    assert np.load(tmp_path / "step_00000005" / entries["b/h"]["file"]
                   ).dtype == np.dtype("V2")
    like = {"a": torch.zeros(3, 4), "b": {"c": torch.zeros(3, dtype=torch.int32),
                                           "h": torch.zeros(5, 7,
                                                            dtype=torch.bfloat16)},
            "n": [torch.tensor(0, dtype=torch.int32)]}
    out, extras = mgr.restore(like, verify=True)
    assert extras["data_step"] == 5
    for (pa, a), (pb, b) in zip(tree_paths(out), tree_paths(tree)):
        assert pa == pb and a.dtype == b.dtype
        assert torch.equal(_bits(a), _bits(b)), pa
    with pytest.raises(ValueError, match="shape"):
        mgr.restore({"a": torch.zeros(4, 3)})


def _mixed_tree():
    """bfloat16 leaves (2-D, 0-D, empty) beside float32 and int32 ones,
    from a seed."""
    gen = torch.Generator().manual_seed(11)
    return {"w": torch.randn(3, 5, generator=gen).to(torch.bfloat16),
            "s": torch.tensor(1.5, dtype=torch.bfloat16),
            "e": torch.zeros(0, 4, dtype=torch.bfloat16),
            "f": torch.randn(4, 2, generator=gen),
            "n": {"i": torch.arange(6, dtype=torch.int32).reshape(2, 3),
                  "m": torch.randn(7, generator=gen).to(torch.bfloat16)}}


def test_bfloat16_step_directory_is_the_jax_packages(tmp_path):
    import jax.numpy as jnp

    from repro.checkpoint import CheckpointManager as JManager

    tree = _mixed_tree()
    jtree = {"w": None, "s": None, "e": None, "f": None, "n": {}}
    for path, leaf in tree_paths(tree):
        host = leaf.float().numpy() if leaf.dtype == torch.bfloat16 \
            else leaf.numpy()
        value = jnp.asarray(host, jnp.bfloat16 if leaf.dtype ==
                            torch.bfloat16 else host.dtype)
        if "/" in path:
            jtree["n"][path.split("/")[1]] = value
        else:
            jtree[path] = value
    CheckpointManager(str(tmp_path / "port")).save(
        3, tree, extras={"data_step": 3})
    JManager(str(tmp_path / "jax")).save(3, jtree, extras={"data_step": 3})
    port, ref = (tmp_path / d / "step_00000003" for d in ("port", "jax"))
    names = sorted(os.listdir(ref))
    assert sorted(os.listdir(port)) == names and "manifest.json" in names
    assert len(names) == 1 + len(tree_paths(tree))
    for name in names:
        assert (port / name).read_bytes() == (ref / name).read_bytes(), name
    with open(port / "manifest.json") as f:
        dtypes = {e["path"]: e["dtype"] for e in json.load(f)["leaves"]}
    assert dtypes == {"e": "bfloat16", "f": "float32", "n/i": "int32",
                      "n/m": "bfloat16", "s": "bfloat16", "w": "bfloat16"}


def test_restores_its_own_and_older_uint16_bfloat16_leaves_bitwise(tmp_path):
    """A ``<V2`` leaf as the port writes it now and a ``<u2`` one as it
    wrote it before: both restore to the saved bits."""
    import hashlib

    tree = _mixed_tree()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tree)
    d = tmp_path / "step_00000001"
    with open(d / "manifest.json") as f:
        manifest = json.load(f)
    for e in manifest["leaves"]:          # rewrite every bf16 leaf as <u2
        if e["dtype"] == "bfloat16":
            bits = np.load(d / e["file"]).view(np.uint16)
            np.save(d / e["file"], bits)
            e["sha256"] = hashlib.sha256(
                (d / e["file"]).read_bytes()).hexdigest()
            assert np.load(d / e["file"]).dtype == np.uint16
    mgr.save(2, tree)
    with open(d / "manifest.json", "w") as f:
        json.dump(manifest, f)
    like = {"w": torch.zeros(3, 5, dtype=torch.bfloat16),
            "s": torch.tensor(0.0, dtype=torch.bfloat16),
            "e": torch.zeros(0, 4, dtype=torch.bfloat16),
            "f": torch.zeros(4, 2),
            "n": {"i": torch.zeros(2, 3, dtype=torch.int32),
                  "m": torch.zeros(7, dtype=torch.bfloat16)}}
    for step in (1, 2):
        out, _ = mgr.restore(like, step=step, verify=True)
        for (pa, a), (pb, b) in zip(tree_paths(out), tree_paths(tree)):
            assert pa == pb and a.dtype == b.dtype, pa
            assert torch.equal(_bits(a), _bits(b)), (step, pa)


def test_corrupt_leaf_raises_checksum_error(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"x": torch.ones(64)})
    path = tmp_path / "step_00000001" / "leaf_00000.npy"
    raw = bytearray(path.read_bytes())
    raw[-1] ^= 0xFF
    path.write_bytes(bytes(raw))
    with pytest.raises(ChecksumError, match="checksum mismatch"):
        mgr.restore({"x": torch.zeros(64)}, verify=True)


def test_async_save_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in range(5):
        x = torch.full((4,), float(s))
        mgr.save_async(s, {"x": x})
        x.fill_(-1.0)              # the snapshot was taken at the call
    mgr.wait()
    assert mgr.all_steps() == [3, 4]
    out, _ = mgr.restore({"x": torch.zeros(4)})
    assert torch.equal(out["x"], torch.full((4,), 4.0))


def test_atomic_no_partial_checkpoints(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"x": torch.ones(3)})
    # a stale tmp dir from a crashed save must not be listed
    os.makedirs(tmp_path / "step_00000099.tmp")
    assert mgr.all_steps() == [1]
    assert mgr.latest_step() == 1


# -- restart --------------------------------------------------------------------

def _pipe():
    return TokenPipeline(DataConfig(vocab=512, batch=4, seq=16, seed=9),
                         device="cpu")


def _run_steps(trainer, state, pipe, dstep, n, injector=None, mgr=None,
               ckpt_every=0, losses=None):
    losses = [] if losses is None else losses   # survives injected failures
    s = state
    while int(s.step) < n:
        if injector:
            injector.check(int(s.step))
        batch, dstep = pipe.next_batch(dstep)
        s, m = trainer.step(s, batch)
        losses.append(float(m["loss"]))
        if mgr and ckpt_every and int(s.step) % ckpt_every == 0:
            mgr.save(int(s.step), s, extras={"data_step": dstep})
    return s, dstep, losses


@pytest.mark.parametrize("backend", ["xla", "shoal"])
def test_failure_restart_resumes_identically(tmp_path, backend):
    """Train 6 steps straight vs train with a crash at 4 + restore: the
    loss trajectories and final params match (float32)."""
    trainer = port_trainer(TrainerConfig(comm_backend=backend), kernels=2)
    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    ref_state, _, ref_losses = _run_steps(trainer, trainer.init_state(gen()),
                                          _pipe(), 0, 6)
    mgr = CheckpointManager(str(tmp_path))
    losses = []
    with pytest.raises(RuntimeError, match="injected failure at step 4"):
        _run_steps(trainer, trainer.init_state(gen()), _pipe(), 0, 6,
                   injector=FailureInjector({4}), mgr=mgr, ckpt_every=2,
                   losses=losses)
    # launcher-style recovery: restore last good checkpoint + data state
    s, extras = mgr.restore(trainer.init_state(gen()))
    assert int(s.step) == 4 and extras["data_step"] == 4
    s, _, more = _run_steps(trainer, s, _pipe(), extras["data_step"], 6)
    losses = losses[:4] + more
    assert len(losses) == 6
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-6)
    assert_trees_close(port_arrays(s.params), port_arrays(ref_state.params),
                       1e-6)


def test_launcher_fail_at_resumes_identically(tmp_path, capsys):
    common = ["--reduced", "--device", "cpu", "--steps", "6", "--batch", "4",
              "--seq", "16", "--ckpt-every", "2", "--log-every", "1",
              "--backend", "shoal", "--kernels", "2"]
    assert launch_train.main(common + ["--ckpt-dir",
                                       str(tmp_path / "straight")]) == 0
    straight = capsys.readouterr().out
    assert launch_train.main(common + ["--ckpt-dir", str(tmp_path / "crash"),
                                       "--fail-at", "4"]) == 0
    crashed = capsys.readouterr().out
    assert "attempt 0 failed: injected failure at step 4" in crashed
    assert "[launch] restored step" in crashed

    def losses(out):
        return {line.split()[2]: float(line.split()[4])
                for line in out.splitlines() if line.startswith("[train]")}

    assert losses(crashed) == losses(straight)
    assert set(losses(straight)) == {str(s) for s in range(1, 7)}
    like = port_trainer(TrainerConfig(comm_backend="shoal"),
                        kernels=2).init_state(torch.Generator().manual_seed(1))
    a, ea = CheckpointManager(str(tmp_path / "straight")).restore(like)
    b, eb = CheckpointManager(str(tmp_path / "crash")).restore(like)
    assert ea == eb == {"data_step": 6}
    assert_trees_close(port_arrays(b), port_arrays(a), 1e-6)


# -- the JAX package's format ----------------------------------------------------

def test_jax_checkpoint_of_the_float32_trainer_restores_into_the_port(
        tmp_path):
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.checkpoint import CheckpointManager as JManager
    from repro.models.model import build_model as jbuild
    from repro.optim.adamw import AdamWConfig as JAdamW
    from repro.training.train import Trainer as JTrainer
    from repro.training.train import TrainerConfig as JConfig

    jtr = JTrainer(jbuild(jconfigs.reduced("tinyllama-1.1b")),
                   JAdamW(lr=1e-3), JConfig(donate=False))
    fn = jtr.make_train_step()
    jb = [{k: jnp.asarray(v) for k, v in batch_np(s).items()}
          for s in range(2)]
    jst, _ = fn(jtr.init_state(jax.random.PRNGKey(0)), jb[0])
    JManager(str(tmp_path)).save(1, jst, extras={"data_step": 1})
    jnext, jmet = fn(jst, jb[1])

    trainer = port_trainer()
    like = trainer.init_state(torch.Generator().manual_seed(5))
    st, extras = CheckpointManager(str(tmp_path)).restore(like, verify=True)
    assert extras == {"data_step": 1} and int(st.step) == 1
    got, want = port_arrays(st), jax_arrays(jst)
    assert got.keys() == want.keys()
    for path in want:
        np.testing.assert_array_equal(got[path], want[path], err_msg=path)
    new, met = trainer.step(st, to_port(batch_np(1)))
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               rtol=1e-5, atol=1e-5)
    assert_trees_close(port_arrays(new.params), jax_arrays(jnext.params),
                       1e-5)
    assert_trees_close(port_arrays(new.opt_state),
                       jax_arrays(jnext.opt_state), 1e-5)


def test_checkpoint_at_four_kernels_restores_at_two(tmp_path):
    four = port_trainer(TrainerConfig(comm_backend="shoal"), kernels=4)
    two = port_trainer(TrainerConfig(comm_backend="shoal"), kernels=2)
    st = four.init_state(torch.Generator().manual_seed(0))
    st, _ = four.step(st, to_port(batch_np(0)))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, st, extras={"data_step": 1})
    restored, _ = mgr.restore(two.init_state(torch.Generator().manual_seed(3)))
    want, _ = four.step(st, to_port(batch_np(1)))
    got, _ = two.step(restored, to_port(batch_np(1)))
    assert int(got.step) == 2
    assert_trees_close(port_arrays(got.params), port_arrays(want.params),
                       1e-5)
    assert two.ctx.exchanges == 12 * 2 * (2 - 1)
