"""The port's dense and audio families against the JAX package's, on the
CPU: qwen2-1.5b, deepseek-7b, qwen2-72b and musicgen-medium, each at its
reduced config (``configs.reduced(arch)``, float32).

In process, JAX on one device, the JAX package's ``Model.init`` weights
carried across with ``params_from_numpy`` (biases, norm offsets and
embeddings perturbed so that qkv bias and LayerNorm bias carry weight):

* the configs' fields, full and reduced;
* the weight trees: the port's init and the carried-across JAX tree have
  the same paths and shapes (the audio family keeps its unused token
  embedding, as the JAX package's ``init`` makes it), and every leaf
  comes across unchanged;
* one prefill (through the flash route: the kernel's plain version on
  the CPU) and one decode step: logits and caches within rtol = atol =
  1e-5 (the same float32 operations, in other orders); musicgen-medium
  is fed frame embeddings, ``(B, S, d)`` and ``(B, 1, d)``;
* ``Model.loss`` and its gradient against ``jax.value_and_grad``: loss
  1e-5, every leaf within 1e-4 of its largest |gradient| (the audio
  family's untied embedding gets exact zeros in both).

The JAX ``shoal`` trainer of qwen2-smoke, deepseek-7b-smoke and
musicgen-smoke runs on 8
emulated CPU devices in one subprocess (``python
tests/test_torch_models.py OUT.npz``, mesh ``("data", "model")`` = (4,
2)): the port's shoal step with K = 4 against it -- ``ctx.exchanges``
equal to the compiled step's collective-permute count, the synced
gradients within 1e-5 of each leaf's largest value, parameters after
the update 1e-4 (``tests/test_torch_train.py``'s bounds).
"""

import dataclasses
import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_reference import run_reference  # noqa: E402
from test_torch_train import (_jax_synced_grads, jax_arrays,  # noqa: E402
                              port_arrays)

from repro_torch import configs  # noqa: E402
from repro_torch.data import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.convert import (cache_from_numpy,  # noqa: E402
                                        params_from_numpy)
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.training import Trainer, TrainerConfig  # noqa: E402
from repro_torch.tree import tree_paths  # noqa: E402

ARCHS = ["qwen2-1.5b", "deepseek-7b", "qwen2-72b", "musicgen-medium"]
SHOAL_ARCHS = ["qwen2-1.5b", "deepseek-7b", "musicgen-medium"]
SLOTS, TOL = 16, 1e-5
BATCH, SEQ, DATA_SEED, LR, SHOAL_K = 8, 16, 1, 1e-3, 4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("name", "family", "n_layers", "d_model", "n_heads", "n_kv_heads",
          "d_ff", "vocab", "dh", "qkv_bias", "tie_embeddings", "rope_base",
          "norm", "mlp", "frontend", "moe", "mla")


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_np(v) for v in tree]
    t = tree.detach().cpu()
    return (t if t.dtype == torch.int32 else t.float()).numpy()


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def batch_np(cfg, step=0, batch=BATCH, seq=SEQ):
    """``TokenPipeline``'s batch for ``cfg``: tokens, or frame embeddings
    for the embeddings frontend (bitwise the JAX package's)."""
    kind = "embeddings" if cfg.frontend == "embeddings" else "tokens"
    return TokenPipeline(DataConfig(vocab=cfg.vocab, batch=batch, seq=seq,
                                    seed=DATA_SEED, kind=kind,
                                    d_model=cfg.d_model),
                         device="cpu").batch_at(step)


def to_port(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def pair(arch):
    """(jax model, jax params, port model, port params, numpy tree) of
    the reduced config, the JAX weights perturbed and carried across."""
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.models.model import build_model as jbuild

    jm = jbuild(jconfigs.reduced(arch))
    tree = jax.tree.map(
        lambda a: a + 0.1 * np.sin(np.arange(a.size)).reshape(a.shape).astype(
            np.float32) if a.ndim <= 2 else a,
        jax.device_get(jm.init(jax.random.PRNGKey(0))))
    cfg = configs.reduced(arch)
    tm = build_model(cfg, device="cpu")
    return (jm, jax.tree.map(jnp.asarray, tree), tm,
            params_from_numpy(cfg, tree, device="cpu"), tree)


@pytest.fixture
def flash_calls(monkeypatch):
    calls = []
    real = tattn.flash_attention

    def counted(q, k, v):
        calls.append(q.shape)
        return real(q, k, v)

    monkeypatch.setattr(tattn, "flash_attention", counted)
    return calls


def _inputs(cfg, B, S, seed):
    """A prompt: token ids, or frame embeddings as the pipeline draws
    them (standard normal x 0.02)."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "embeddings":
        return "embeddings", (rng.standard_normal(
            (B, S, cfg.d_model)) * 0.02).astype(np.float32)
    return "tokens", rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)


def _port_input(a):
    return torch.from_numpy(a).long() if a.dtype == np.int32 \
        else torch.from_numpy(a)


# -- configs and weights -----------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_the_jax_package(arch):
    import jax.numpy as jnp

    from repro import configs as jconfigs

    for name in ("full", "reduced"):
        got = getattr(configs, name)(arch)
        want = getattr(jconfigs, name)(arch)
        for f in FIELDS:
            assert getattr(got, f) == getattr(want, f), (arch, name, f)
        assert str(got.dtype).split(".")[-1] == jnp.dtype(want.dtype).name
        assert got.segments() == want.segments()
    full = configs.full(arch)
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.d_ff, full.vocab) == {
        "qwen2-1.5b": (28, 1536, 12, 2, 8960, 151936),
        "deepseek-7b": (30, 4096, 32, 32, 11008, 102400),
        "qwen2-72b": (80, 8192, 64, 8, 29568, 152064),
        "musicgen-medium": (48, 1536, 24, 24, 6144, 2048)}[arch]
    assert full.dtype == torch.bfloat16
    # the route's switches are ported (the ring reads them), and so is
    # the memory policy remat; the sharding policy fsdp is not
    want = jconfigs.full(arch)
    assert (full.tp, full.seq_shard) == (want.tp, want.seq_shard) \
        == (True, False)
    assert full.remat == want.remat == "dots"
    assert configs.reduced(arch).remat == jconfigs.reduced(arch).remat \
        == "none"
    assert not hasattr(full, "fsdp")


@pytest.mark.parametrize("arch", ARCHS)
def test_weight_trees_carry_across_unchanged(arch):
    """The port's init has the JAX package's tree (paths, shapes) -- the
    audio family's token embedding included -- and
    ``params_from_numpy`` carries every JAX leaf across unchanged."""
    _, _, tm, tparams, tree = pair(arch)
    own = tm.init(torch.Generator().manual_seed(0))
    shapes = {p: tuple(t.shape) for p, t in tree_paths(own)}
    carried = port_arrays(tparams)
    want = jax_arrays(tree)
    assert list(carried) == list(want) == list(shapes)
    for path, arr in want.items():
        assert shapes[path] == arr.shape, path
        np.testing.assert_array_equal(carried[path], arr, err_msg=path)
    cfg = tm.cfg
    assert "embed" in shapes and ("lm_head" in shapes) != cfg.tie_embeddings


# -- serving -----------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch, flash_calls):
    """One 2-lane prefill of 7 positions on a fresh cache (the flash
    route, once per layer), then one decode step at mixed positions."""
    import jax
    import jax.numpy as jnp

    jm, jparams, tm, tparams, _ = pair(arch)
    cfg = tm.cfg
    key, prompt = _inputs(cfg, 2, 7, 3)
    jcache = jm.make_cache(2, SLOTS)
    tcache = cache_from_numpy(cfg, jax.device_get(jcache), device="cpu")
    jl, jc = jax.jit(jm.prefill)(jparams, {key: jnp.asarray(prompt)}, jcache)
    tl, tc = tm.prefill(tparams, {key: _port_input(prompt)}, tcache)
    _close(_np(tl), np.asarray(jl))
    assert len(flash_calls) == cfg.n_layers
    _, step = _inputs(cfg, 2, 1, 4)
    pos = np.array([7, 5], np.int32)
    jl, jc = jax.jit(jm.decode_step)(jparams, jc, jnp.asarray(step),
                                     jnp.asarray(pos))
    tl, tc = tm.decode_step(tparams, tc, _port_input(step),
                            torch.from_numpy(pos).long())
    _close(_np(tl), np.asarray(jl))
    for got, want in zip(jax.tree.leaves(_np(tc)),
                         jax.tree.leaves(jax.device_get(jc))):
        _close(got, np.asarray(want, got.dtype))
    assert len(flash_calls) == cfg.n_layers       # decode: the plain route


def test_the_embeddings_frontend_is_not_scaled():
    """Frame embeddings enter as they are, cast to ``cfg.dtype``; tokens
    are scaled by sqrt(d_model), as in the JAX package."""
    import math

    cfg = dataclasses.replace(configs.reduced("musicgen-medium"),
                              dtype=torch.bfloat16)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    x = torch.randn(2, 3, cfg.d_model)
    got = model._embed_in(params, {"embeddings": x})
    assert got.dtype == torch.bfloat16 and torch.equal(got,
                                                       x.to(torch.bfloat16))
    tok = dataclasses.replace(cfg, frontend="tokens")
    ids = torch.tensor([[1, 2]])
    want = params["embed"][ids] * torch.tensor(math.sqrt(cfg.d_model),
                                               dtype=torch.bfloat16)
    assert torch.equal(build_model(tok, device="cpu")._embed_in(
        params, {"tokens": ids}), want)


# -- training ----------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax(arch, flash_calls):
    import jax
    import jax.numpy as jnp

    jm, jparams, tm, tparams, _ = pair(arch)
    batch = batch_np(tm.cfg, batch=4)
    jloss, jgrads = jax.value_and_grad(jm.loss)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    trainer = Trainer(tm, AdamWConfig(lr=LR))
    loss, grads = trainer.value_and_grad(tparams, to_port(batch))
    assert not flash_calls, "Model.loss took the forward-only flash route"
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5,
                               atol=1e-5)
    got, want = port_arrays(grads), jax_arrays(jgrads)
    assert list(got) == list(want)
    for path in want:
        scale = np.abs(want[path]).max()
        np.testing.assert_allclose(got[path], want[path], rtol=0,
                                   atol=1e-4 * scale, err_msg=path)
    if not tm.cfg.tie_embeddings and tm.cfg.frontend == "embeddings":
        assert not got["embed"].any() and not want["embed"].any()


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

    out = {}
    mesh = make_mesh((SHOAL_K, 8 // SHOAL_K), ("data", "model"))
    for arch in SHOAL_ARCHS:
        cfg = jconfigs.reduced(arch)
        b = {k: jax.device_put(v, NamedSharding(mesh, P(("data",))))
             for k, v in batch_np(cfg).items()}
        tr = JTrainer(jbuild(cfg, mesh=mesh, dp_axes=()), JAdamW(lr=LR),
                      JConfig(comm_backend="shoal", donate=False),
                      dp_axes=("data",))
        st = tr.init_state(jax.random.PRNGKey(0))
        compiled = tr.make_train_step().lower(st, b).compile()
        new, met = compiled(st, b)
        tag = f"{arch}/K{SHOAL_K}/f32"
        out[f"{tag}/loss"] = np.asarray(met["loss"])
        out[f"{tag}/grad_norm"] = np.asarray(met["grad_norm"])
        out[f"{tag}/cps"] = np.asarray(cp_count(compiled))
        for path, arr in jax_arrays(new.params).items():
            out[f"{tag}/params/{path}"] = arr
        for path, arr in jax_arrays(new.opt_state["m"]).items():
            out[f"{tag}/m/{path}"] = arr
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(__file__,
                         tmp_path_factory.mktemp("models") / "ref.npz")


@pytest.mark.parametrize("arch", SHOAL_ARCHS)
def test_shoal_step_matches_the_jax_shoal_trainer(reference, arch):
    """K = 4 members from the JAX init (unperturbed, as the JAX trainer
    draws it): the exchanges are the compiled JAX step's
    collective-permutes (one ring of 2(K - 1) a leaf, qwen2's tied
    embedding one leaf, musicgen's unread embedding all-reduced as
    zeros), then the synced gradients and the updated parameters."""
    import jax

    from repro import configs as jconfigs
    from repro.models.model import build_model as jbuild

    cfg = configs.reduced(arch)
    params_np = jax.device_get(jbuild(jconfigs.reduced(arch)).init(
        jax.random.PRNGKey(0)))
    trainer = Trainer(build_model(cfg, device="cpu"), AdamWConfig(lr=LR),
                      TrainerConfig(comm_backend="shoal"), kernels=SHOAL_K)
    st = trainer.state_for(params_from_numpy(cfg, params_np, device="cpu"))
    tag = f"{arch}/K{SHOAL_K}/f32"
    loss, grads, _ = trainer.grads(st, to_port(batch_np(cfg)))
    leaves = len(tree_paths(st.params))
    assert leaves == {"qwen2-1.5b": 14, "deepseek-7b": 12,
                      "musicgen-medium": 16}[arch]
    assert trainer.ctx.exchanges == int(reference[f"{tag}/cps"])
    assert abs(float(loss) - float(reference[f"{tag}/loss"])) < 1e-4
    want_g, got_g = _jax_synced_grads(reference, tag), port_arrays(grads)
    assert got_g.keys() == want_g.keys()
    for path, want in want_g.items():
        np.testing.assert_allclose(got_g[path], want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=path)
    new, _ = trainer.apply_update(st, grads, loss)
    head = f"{tag}/params/"
    want = {p[len(head):]: v for p, v in reference.items()
            if p.startswith(head)}
    got = port_arrays(new.params)
    assert got.keys() == want.keys()
    for path in want:
        assert np.abs(got[path] - want[path]).max() < 1e-4, path


# -- launchers and examples --------------------------------------------------

def test_launch_train_feeds_the_audio_family_frame_embeddings(tmp_path,
                                                              capsys):
    import argparse

    from repro_torch.launch import train as launch_train

    _, _, _, pipe = launch_train.make_parts(argparse.Namespace(
        arch="musicgen-medium", reduced=True, device="cpu", lr=3e-4,
        warmup=1, steps=3, backend="shoal", microbatches=1, kernels=2,
        batch=4, seq=16, seed=0))
    assert pipe.cfg.kind == "embeddings" and pipe.cfg.d_model == 64
    assert launch_train.main([
        "--arch", "musicgen-medium", "--reduced", "--device", "cpu",
        "--steps", "3", "--batch", "4", "--seq", "16", "--log-every", "1",
        "--backend", "shoal", "--kernels", "2", "--ckpt-dir",
        str(tmp_path)]) == 0
    losses = [float(line.split()[4]) for line in
              capsys.readouterr().out.splitlines()
              if line.startswith("[train]")]
    assert len(losses) == 3 and all(np.isfinite(losses))


def test_launch_serve_refuses_the_embeddings_frontend(capsys):
    from repro_torch.launch import serve

    with pytest.raises(SystemExit, match="token-frontend"):
        serve.main(["--arch", "musicgen-medium", "--reduced", "--device",
                    "cpu"])
    assert serve.main(["--arch", "deepseek-7b", "--reduced", "--device",
                       "cpu", "--requests", "2", "--max-new", "3"]) == 0
    assert "deepseek-7b-smoke: 2 requests, 6 tokens" in \
        capsys.readouterr().out


def _run_example(name, *args):
    """``examples/<name> --device cpu ...`` with JAX and the JAX package
    blocked; returns its standard output."""
    code = ("import runpy, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            f"sys.argv = [{name!r}, '--device', 'cpu', *{list(args)!r}]\n"
            f"runpy.run_path({os.path.join(REPO, 'examples', name)!r}, "
            "run_name='__main__')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_serve_lm_example_runs_on_the_cpu():
    out = _run_example("torch_serve_lm.py")
    assert out.count("req ") == 6
    assert "[serve] qwen2-smoke: 6 requests, 72 tokens" in out


def test_serve_lm_example_serves_the_moe_family_on_the_cpu():
    out = _run_example("torch_serve_lm.py", "--arch", "dbrx-132b")
    assert out.count("req ") == 6
    assert "[serve] dbrx-smoke: 6 requests, 72 tokens" in out


def test_launch_train_trains_the_moe_family(tmp_path, capsys):
    """dbrx-smoke through the launcher's shoal trainer: the loss is
    cross-entropy plus 0.01 x the MoE layers' aux, finite."""
    from repro_torch.launch import train as launch_train

    assert launch_train.main([
        "--arch", "dbrx-132b", "--reduced", "--device", "cpu",
        "--steps", "2", "--batch", "4", "--seq", "16", "--log-every", "1",
        "--backend", "shoal", "--kernels", "2", "--ckpt-dir",
        str(tmp_path)]) == 0
    losses = [float(line.split()[4]) for line in
              capsys.readouterr().out.splitlines()
              if line.startswith("[train]")]
    assert len(losses) == 2 and all(np.isfinite(losses))


def test_train_lm_example_recovers_from_its_failure_on_the_cpu():
    out = _run_example("torch_train_lm.py", "--steps", "20")
    assert "attempt 0 failed: injected failure at step 10" in out
    assert "[launch] done at step 20" in out


if __name__ == "__main__":
    _run_reference(sys.argv[1])
