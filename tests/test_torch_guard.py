"""Guards of the PyTorch port: it imports neither JAX nor the JAX package,
runs on the CUDA card unless told otherwise, never hides a device or a
kernel behind a fallback, and refuses what it does not implement."""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import handlers as hd, ops
from repro_torch.core.address_space import GlobalAddressSpace
from repro_torch.core.state import (ERR_WAIT_UNDERFLOW, ShoalContext,
                                    WaitUnderflowError, raise_on_error,
                                    replace, state_from_numpy,
                                    state_to_numpy)
from repro_torch.kernels import (am_pack as dm, gascore_dma as gd,
                                 jacobi as jk, launch_counts,
                                 reset_launch_counts)
from repro_torch.runtime import TCP, LossyTransport

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = re.compile(r"^\s*(import jax|from jax|import repro\b|"
                       r"from repro(\.| ))", re.M)


def test_port_sources_import_no_jax_and_no_reference():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py", REPO / "scripts" / "torch_comm_lint.py"]
    files += sorted((REPO / "examples").glob("torch_*.py"))
    assert len(files) > 15
    assert REPO / "src" / "repro_torch" / "analysis" / "rules.py" in files
    for name in ("torch_serve_lm.py", "torch_train_lm.py",
                 "torch_serve_disagg.py", "torch_quickstart.py",
                 "torch_jacobi_stencil.py"):
        assert REPO / "examples" / name in files
    bad = [f"{f}: {m.group(0).strip()}" for f in files
           for m in FORBIDDEN.finditer(f.read_text())]
    assert not bad, bad


def test_port_imports_and_runs_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import numpy as np\n"
        "import repro_torch, repro_torch.core, repro_torch.kernels\n"
        "import repro_torch.runtime, repro_torch.apps\n"
        "from repro_torch.apps.jacobi import JacobiApp, jacobi_reference\n"
        "g = np.arange(256, dtype=np.float32).reshape(16, 16)\n"
        "out = JacobiApp(n=16, kernels=4, iters=3, device='cpu').run(g)\n"
        "assert np.array_equal(out, jacobi_reference(g, 3, 'cpu'))\n"
        "print('port-ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "port-ok" in proc.stdout


EXAMPLES = {"torch_quickstart.py": "quickstart OK",
            "torch_jacobi_stencil.py":
                "jacobi example OK (same source, four topologies)"}


def _run_example(name, argv, jax_blocked=True):
    code = ("import runpy, sys\n"
            + ("sys.modules['jax'] = None\n"
               "sys.modules['repro'] = None\n" if jax_blocked else "")
            + f"sys.argv = [{name!r}] + {argv!r}\n"
            f"runpy.run_path({str(REPO / 'examples' / name)!r}, "
            "run_name='__main__')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_examples_run_on_the_cpu_with_jax_blocked(name):
    """``examples/torch_quickstart.py`` (puts, a remote accumulate, a
    barrier, a get, a ring all-reduce) and
    ``examples/torch_jacobi_stencil.py`` (512 x 512, 64 iterations on
    1, 2, 4 and 8 kernels against the oracle, < 1e-5) print their OK
    lines with ``--device cpu`` and JAX and the JAX package blocked."""
    proc = _run_example(name, ["--device", "cpu"])
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.rstrip().splitlines()[-1] == EXAMPLES[name]
    if name == "torch_jacobi_stencil.py":
        for k in (1, 2, 4, 8):
            assert f"kernels={k}:" in proc.stdout


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_examples_default_to_the_card(name):
    """Without ``--device`` the examples run on the card; without one
    they raise instead of falling back to the CPU."""
    proc = _run_example(name, [])
    if torch.cuda.is_available():
        assert proc.returncode == 0, proc.stderr[-3000:]
        assert EXAMPLES[name] in proc.stdout
        return
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr and EXAMPLES[name] not in proc.stdout


def test_default_device_is_the_card():
    """No device means CUDA; without a card that raises instead of
    falling back to the CPU."""
    from repro_torch.apps.jacobi import JacobiApp, jacobi_reference

    if torch.cuda.is_available():
        assert ShoalContext(2).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        ShoalContext(2)
    with pytest.raises(RuntimeError, match="CUDA"):
        JacobiApp(n=8, kernels=2, iters=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        jacobi_reference(np.zeros((4, 4), np.float32), 1)
    assert ShoalContext(2, device="cpu").device.type == "cpu"


def test_state_helpers_default_to_the_card():
    """``PgasState.make`` and ``state_from_numpy`` place their tensors on
    the card unless given ``device="cpu"``; without a card they raise."""
    from repro_torch.core.state import PgasState

    arrays = state_to_numpy(PgasState.make(2, 8, device="cpu"))
    if torch.cuda.is_available():
        assert PgasState.make(2, 8).segment.device.type == "cuda"
        assert state_from_numpy(arrays).credits.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        PgasState.make(2, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        state_from_numpy(arrays)
    assert state_from_numpy(arrays, device="cpu").segment.shape == (2, 8)


def test_serving_entry_points_default_to_the_card():
    """``build_model`` (and so ``ServeEngine``, which serves on its
    model's device), the weight conversion and ``launch.serve`` pick the
    card by default and raise without one."""
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models.convert import (cache_from_numpy,
                                            params_from_numpy)
    from repro_torch.models.model import build_model
    from repro_torch.serving import ServeEngine

    cfg = configs.reduced("tinyllama-1.1b")
    if torch.cuda.is_available():
        assert build_model(cfg).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--reduced", "--requests", "1"])
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    engine = ServeEngine(model, params, lanes=1, slots=8)
    assert engine.device.type == "cpu"
    assert engine.cache[0]["b0_dense"]["k"].device.type == "cpu"
    tree = {"embed": np.zeros((4, 2), np.float32)}
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_numpy(cfg, tree)
    with pytest.raises(RuntimeError, match="CUDA"):
        cache_from_numpy(cfg, [])


def test_serving_stack_runs_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch.models, repro_torch.serving, repro_torch.actors\n"
        "import repro_torch.configs, repro_torch.launch.serve\n"
        "import repro_torch.models.convert, repro_torch.kernels.attention\n"
        "from repro_torch.launch import serve\n"
        "assert serve.main(['--reduced', '--device', 'cpu', '--requests',\n"
        "                   '2', '--max-new', '3']) == 0\n"
        "print('serve-ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "serve-ok" in proc.stdout


def test_disagg_tier_defaults_to_the_card():
    """The disaggregated tier's context resolves ``device=None`` to the
    card (and must sit on its model's device); without a card it
    raises instead of falling back to the CPU."""
    from repro_torch import configs
    from repro_torch.launch.mesh import ServingSlices
    from repro_torch.models.model import build_model
    from repro_torch.serving import DisaggServeTier

    cfg = configs.reduced("tinyllama-1.1b")
    slices = ServingSlices(n_prefill=1, n_decode=1)
    if torch.cuda.is_available():
        model = build_model(cfg)
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        tier = DisaggServeTier(model, params, slices, lanes_per_decode=1,
                               slots=8)
        assert tier.ctx.device.type == "cuda"
        assert tier.state.segment.device.type == "cuda"
        return
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        DisaggServeTier(model, params, slices, lanes_per_decode=1, slots=8)
    tier = DisaggServeTier(model, params, slices, lanes_per_decode=1,
                           slots=8, device="cpu")
    assert tier.state.segment.device.type == "cpu"
    with pytest.raises(ValueError, match="model on"):
        DisaggServeTier(model, params, slices, lanes_per_decode=1, slots=8,
                        device="meta")


def test_disagg_stack_runs_with_jax_blocked():
    """The KV space, the tier and the front end import and serve with
    JAX and the JAX package blocked."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import numpy as np, torch\n"
        "import repro_torch.launch.mesh, repro_torch.serving.kv_space\n"
        "import repro_torch.serving.disagg, repro_torch.serving.frontend\n"
        "from repro_torch import configs\n"
        "from repro_torch.launch.mesh import ServingSlices\n"
        "from repro_torch.models.model import build_model\n"
        "from repro_torch.serving import DONE, DisaggServeTier, ServeFrontend\n"
        "cfg = configs.reduced('tinyllama-1.1b')\n"
        "m = build_model(cfg, device='cpu')\n"
        "p = m.init(torch.Generator().manual_seed(0))\n"
        "tier = DisaggServeTier(m, p, ServingSlices(1, 1),\n"
        "                       lanes_per_decode=1, slots=8, device='cpu')\n"
        "fe = ServeFrontend(tier, max_queue=2)\n"
        "jobs = [fe.submit([1, 2, 3], 2), fe.submit([4, 5], 2)]\n"
        "fe.run_until_idle()\n"
        "assert all(j.status == DONE for j in jobs), jobs\n"
        "assert tier.migrations == 2 and tier.ctx.exchanges == 4\n"
        "print('disagg-ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "disagg-ok" in proc.stdout


def test_analysis_and_lint_cli_run_with_jax_blocked(tmp_path):
    """The lint package, its registry and the lint CLI import and lint
    every entry with JAX and the JAX package blocked."""
    code = (
        "import json, runpy, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "from repro_torch.analysis import budget, registry, rules, trace\n"
        "out = sys.argv[2]\n"
        "sys.argv = [sys.argv[1], '--device', 'cpu', '--json', out]\n"
        "try:\n"
        "    runpy.run_path(sys.argv[0], run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "doc = json.load(open(out))\n"
        "assert len(doc['entries']) == 6\n"
        "assert all(r['ok'] for r in doc['entries'].values())\n"
        "print('lint-ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code,
                           str(REPO / "scripts" / "torch_comm_lint.py"),
                           str(tmp_path / "lint.json")], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "lint-ok" in proc.stdout


def test_lint_entry_points_default_to_the_card():
    """``run_entry`` and the lint CLI run on the card unless asked for
    the CPU; without a card they raise instead of falling back."""
    from repro_torch.analysis import registry

    if torch.cuda.is_available():
        run = registry.lint_entry("jacobi")
        assert run.result[0].segment.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        registry.run_entry("jacobi")
    proc = subprocess.run(
        [sys.executable, str(REPO / "scripts" / "torch_comm_lint.py"),
         "--entry", "jacobi"], capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(REPO / "src")))
    assert proc.returncode != 0 and "CUDA" in proc.stderr
    assert registry.run_entry("jacobi", device="cpu").ok


def test_training_stack_runs_with_jax_blocked(tmp_path):
    """The optimizer, data, checkpoint and training packages and the
    training launcher import and train with JAX and the JAX package
    blocked (a failure injected at step 2, resumed)."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch.optim, repro_torch.data, repro_torch.checkpoint\n"
        "import repro_torch.training, repro_torch.training.elastic\n"
        "import repro_torch.training.pipeline, repro_torch.launch.train\n"
        "from repro_torch.launch import train\n"
        "assert train.main(['--reduced', '--device', 'cpu', '--steps', '3',\n"
        "                   '--batch', '4', '--seq', '8', '--backend',\n"
        "                   'shoal', '--kernels', '2', '--ckpt-every', '1',\n"
        "                   '--fail-at', '2', '--ckpt-dir', sys.argv[1]]) == 0\n"
        "print('train-ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "train-ok" in proc.stdout
    assert "injected failure at step 2" in proc.stdout


@pytest.mark.parametrize("launcher", ["serve", "train"])
def test_xlstm_launchers_run_with_jax_blocked(launcher, tmp_path):
    """``launch.serve`` and ``launch.train`` (the shoal backend on 2
    members) drive xlstm-smoke on the CPU with JAX and the JAX package
    blocked."""
    argv = {"serve": "['--arch', 'xlstm-350m', '--reduced', '--device', "
                     "'cpu', '--requests', '3', '--max-new', '3']",
            "train": "['--arch', 'xlstm-350m', '--reduced', '--device', "
                     "'cpu', '--steps', '2', '--batch', '4', '--seq', '20', "
                     "'--backend', 'shoal', '--kernels', '2', "
                     "'--ckpt-dir', sys.argv[1]]"}[launcher]
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"from repro_torch.launch import {launcher}\n"
        f"assert {launcher}.main({argv}) == 0\n"
        "print('xlstm-ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "xlstm-ok" in proc.stdout
    assert {"serve": "[serve] xlstm-smoke: 3 requests",
            "train": "[launch] done at step 2"}[launcher] in proc.stdout


def test_training_entry_points_default_to_the_card(tmp_path):
    """``Trainer`` (through its model and context), ``TokenPipeline`` and
    ``launch.train`` pick the card by default and raise without one."""
    from repro_torch import configs
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.launch import train
    from repro_torch.models.model import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.training import Trainer, TrainerConfig

    cfg = configs.reduced("tinyllama-1.1b")
    dcfg = DataConfig(vocab=cfg.vocab, batch=4, seq=8)
    if torch.cuda.is_available():
        tr = Trainer(build_model(cfg), AdamWConfig(),
                     TrainerConfig(comm_backend="shoal"), kernels=2)
        assert tr.ctx.device.type == "cuda"
        assert TokenPipeline(dcfg).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        TokenPipeline(dcfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--reduced", "--steps", "1", "--ckpt-dir",
                    str(tmp_path)])
    tr = Trainer(build_model(cfg, device="cpu"), AdamWConfig(),
                 TrainerConfig(comm_backend="shoal"), kernels=2)
    assert tr.ctx.device.type == "cpu"
    st = tr.init_state(torch.Generator().manual_seed(0))
    assert {leaf.device.type for leaf in
            [st.step, st.opt_state["count"], st.opt_state["m"]["embed"]]} \
        == {"cpu"}


def test_flash_attention_refuses_inputs_that_require_grad():
    """The flash kernel is forward only: inputs that require grad raise
    on every device (the CPU plain version and the ``meta`` device
    included), outside ``no_grad``; ``Model.loss`` still
    differentiates, through ``_attend``."""
    from repro_torch import configs
    from repro_torch.kernels.attention import flash_attention
    from repro_torch.models.model import build_model

    for device in ("cpu", "meta"):
        q = torch.zeros(1, 4, 2, 8, device=device, requires_grad=True)
        kv = torch.zeros(1, 4, 2, 8, device=device)
        with pytest.raises(RuntimeError, match="Model.loss"):
            flash_attention(q, kv, kv)
        with pytest.raises(RuntimeError, match="Model.loss"):
            flash_attention(kv, kv, q)
    q = torch.randn(1, 4, 2, 8, requires_grad=True)
    with torch.no_grad():
        assert flash_attention(q, q, q).shape == (1, 4, 2, 8)
    cfg = configs.reduced("tinyllama-1.1b")
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    wq = params["segments"][0]["b0_dense"]["attn"]["wq"].requires_grad_()
    tokens = torch.randint(0, cfg.vocab, (2, 6), generator=torch.Generator(
    ).manual_seed(1))
    loss = model.loss(params, {"tokens": tokens, "labels": tokens})
    g, = torch.autograd.grad(loss, wq)
    assert g.abs().sum() > 0
    with pytest.raises(RuntimeError, match="forward-only"):
        model.forward_train(params, {"tokens": tokens})


def test_non_cpu_tensors_never_reach_a_plain_version():
    """A tensor that is not on the CPU goes to the kernel or raises: on
    the ``meta`` device every wrapper refuses."""
    seg = torch.zeros(2, 32, device="meta")
    i32 = torch.zeros(2, 1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        dm.datamover_gather(seg, i32, i32, 8)
    with pytest.raises(ValueError, match="CUDA"):
        dm.datamover_scatter(seg, torch.zeros(2, 1, 8, device="meta"), i32,
                             i32, i32, i32)
    with pytest.raises(ValueError, match="CUDA"):
        jk.jacobi_step(torch.zeros(8, 8, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        jk.jacobi_band_step(torch.zeros(2, 6, 8, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        gd.ring_allreduce_dma(torch.zeros(2, 8, device="meta"))
    for schedule, shape in ((gd.REDUCE_SCATTER, (2, 2, 4)),
                            (gd.ALL_GATHER, (2, 4)),
                            (gd.ALL_REDUCE, (2, 2, 4))):
        with pytest.raises(ValueError, match="CUDA"):
            gd.ring_collective(torch.zeros(shape, device="meta"), schedule)


def test_custom_handlers_refused_off_the_cpu_and_run_on_it():
    """Custom handlers used to be refused on a device; a CUDA segment now
    lands them through the DataMover kernels block by block.  A segment
    that is on neither the CPU nor a CUDA card is still refused (it
    never reaches a plain version), and on the CPU a ``put_long`` with
    a registered handler is the JAX package's ``ingress_long`` with the
    same table, bitwise."""
    import jax.numpy as jnp

    from repro.core import am as jam, gascore as jgc, handlers as jhd
    from repro.core.state import PgasState as JState
    from repro.core.state import ShoalContext as JCtx
    from repro.runtime.topology import make_cpu_mesh

    table = hd.HandlerTable()
    hid = table.register("scale2", lambda r, p: r + 2 * p)
    assert hid == hd.NUM_BUILTIN and not table.builtin_only
    seg = torch.zeros(1, 8, device="meta")
    i32 = torch.zeros(1, 1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        dm.datamover_scatter(seg, torch.zeros(1, 1, 4, device="meta"), i32,
                             i32, i32, i32, table)
    jtable = jhd.HandlerTable()
    assert jtable.register("scale2", lambda r, p: r + 2 * p) == hid
    S, W = 16, 4
    rng = np.random.default_rng(3)
    seg0 = rng.standard_normal((2, S)).astype(np.float32)
    pay = rng.standard_normal((2, W)).astype(np.float32)
    ctx = ShoalContext(2, segment_words=S, device="cpu", handlers=table)
    st = replace(ctx.make_state(), segment=torch.from_numpy(seg0.copy()))
    st = ops.put_long(ctx, st, torch.from_numpy(pay), [(0, 1), (1, 0)],
                      dst_addr=2, handler=hid, token=1)
    jctx = JCtx(mesh=make_cpu_mesh(1, ("kernel",)), axes=("kernel",),
                segment_words=S, handlers=jtable)
    hdr = jam.decode(jam.encode(type=jam.make_type(jam.LONG), nwords=W,
                                dst_addr=2, handler=hid))
    for k in range(2):
        jst = JState.make(S)
        jst = jgc.dataclasses_replace(jst, segment=jnp.asarray(seg0[k]))
        want = jgc.ingress_long(jctx, jst, hdr, jnp.asarray(pay[1 - k]), W)
        np.testing.assert_array_equal(
            st.segment[k].numpy().view(np.int32),
            np.asarray(want.segment).view(np.int32))


def _handler_tables(dtype):
    """A table with ``r + 2 p`` (the JAX package's "scale2") and one
    handler whose result depends on the order blocks land."""
    table = hd.HandlerTable()
    table.register("scale2", lambda r, p: r + 2 * p)
    if dtype == torch.int32:
        table.register("ordered", lambda r, p: 2 * r - p)
    else:
        table.register("ordered", lambda r, p: 0.5 * r + p)
    return table


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
def test_scatter_through_handlers_is_the_plain_scatter(dtype):
    """The custom-handler route (``scatter_through_handlers``) run with
    the plain gather and scatter equals ``datamover_scatter_ref``
    bitwise: overlapping blocks (each later block reads what the earlier
    ones wrote), inactive blocks, lanes past ``nwords`` and past either
    end of the segment, and handler ids past the table's end (clipped to
    its last entry) or below 0 (clipped to NOP)."""
    from repro_torch.kernels.am_pack.ops import scatter_through_handlers
    from repro_torch.kernels.am_pack.ref import (datamover_gather_ref,
                                                 datamover_scatter_ref)

    table = _handler_tables(dtype)
    g = torch.Generator().manual_seed(11)
    K, S, B, W = 3, 48, 9, 8
    if dtype == torch.int32:
        seg = torch.randint(-50, 50, (K, S), generator=g, dtype=dtype)
        pay = torch.randint(-50, 50, (K, B, W), generator=g, dtype=dtype)
    else:
        seg = torch.randn(K, S, generator=g).to(dtype)
        pay = torch.randn(K, B, W, generator=g).to(dtype)
    addr = torch.randint(-6, S + 2, (K, B), generator=g, dtype=torch.int32)
    addr[:, 1:4] = addr[:, :1] + torch.tensor([2, 3, 5], dtype=torch.int32)
    nwords = torch.randint(0, W + 1, (K, B), generator=g, dtype=torch.int32)
    handler = torch.randint(-2, len(table) + 4, (K, B), generator=g,
                            dtype=torch.int32)
    handler[:, 1:4] = torch.tensor([hd.NUM_BUILTIN, hd.NUM_BUILTIN + 1,
                                    len(table) + 3], dtype=torch.int32)
    active = torch.rand(K, B, generator=g) > 0.15
    want = datamover_scatter_ref(seg.clone(), pay, addr, nwords, handler,
                                 active, table)
    got = scatter_through_handlers(
        seg.clone(), pay, addr, nwords, handler, active, table,
        datamover_gather_ref, datamover_scatter_ref)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(got.view(bits), want.view(bits))
    assert not torch.equal(want, seg)
    assert torch.equal(dm.datamover_scatter(seg.clone(), pay, addr, nwords,
                                            handler, active, table).view(bits),
                       want.view(bits))


def test_lossy_transport_refused_at_call_time():
    """Every op without a reliability protocol refuses a lossy
    transport; put_long runs the reliable put there, and refuses only
    the ack lanes that presume a lossless reply."""
    from repro_torch.core.faults import FaultModel

    faults = FaultModel(drop=0.1, seed=1)
    ctx = ShoalContext(2, LossyTransport(faults=faults), 16, device="cpu")
    st = ctx.make_state()
    pat = [(0, 1)]
    pay = torch.ones(2, 4)
    calls = [
        lambda: ops.put_long(ctx, st, pay, pat, 0, defer_ack=True),
        lambda: ops.put_long_vectored(ctx, st, [pay], pat, [0]),
        lambda: ops.put_short(ctx, st, pat),
        lambda: ops.put_medium(ctx, st, pay, pat),
        lambda: ops.put_long_multi(ctx, st, [(pay, pat, 0)]),
        lambda: ops.put_long_strided(ctx, st, pay, pat, 0, 4, blk_words=2,
                                     nblocks=2),
        lambda: ops.get_medium(ctx, st, pat, 0, 4),
        lambda: ops.get_long(ctx, st, pat, 0, 4, 8),
        lambda: ops.drain_deferred_acks(ctx, st, pat, 1),
    ]
    for call in calls:
        with pytest.raises(NotImplementedError, match="lossy"):
            call()
    with pytest.raises(ValueError):
        LossyTransport()


def test_cpu_context_never_launches_a_kernel():
    from repro_torch.apps.jacobi import JacobiApp
    from repro_torch.core import collectives as coll, humboldt

    reset_launch_counts()
    ctx = ShoalContext(4, TCP, 32, device="cpu")
    st = ctx.make_state()
    ring = [(i, (i + 1) % 4) for i in range(4)]
    st = ops.put_long(ctx, st, torch.ones(4, 8), ring, 0, token=1)
    st, _ = ops.get_medium(ctx, st, ring, 0, 8, token=2)
    x = torch.ones(4, 10)
    coll.ring_all_gather(ctx, coll.ring_reduce_scatter(ctx, x))
    coll.ring_all_reduce(ctx, x)
    gd.ring_allreduce_dma(x)
    st, _ = humboldt.sendrecv(ctx, st, x, ring, token=3)
    JacobiApp(n=16, kernels=4, iters=2, device="cpu").run(
        np.ones((16, 16), np.float32))
    assert set(launch_counts().values()) == {0}


def test_state_numpy_roundtrip_and_error_decode():
    ctx = ShoalContext(3, segment_words=8, device="cpu")
    st = ctx.make_state()
    arrays = state_to_numpy(st)
    back = state_to_numpy(state_from_numpy(arrays, device="cpu"))
    assert arrays.keys() == back.keys()
    for f in arrays:
        np.testing.assert_array_equal(arrays[f], back[f])
    with pytest.raises(ValueError, match="missing"):
        state_from_numpy({"segment": arrays["segment"]}, device="cpu")
    assert raise_on_error(st) is st
    st = ops.wait_replies(ctx, st, token=torch.tensor([0, 4, 0]), n=1)
    assert st.error.tolist() == [ERR_WAIT_UNDERFLOW] * 3
    only_kernel_1 = st.error * torch.tensor([0, 1, 0], dtype=torch.int32)
    with pytest.raises(WaitUnderflowError) as info:
        raise_on_error(replace(st, error=only_kernel_1))
    assert info.value.tokens == (0, 4) and info.value.kernels == (1,)


def test_chip_smoke_refuses_without_its_card_or_its_repo(tmp_path):
    """Without a CUDA card, or copied alone into a directory, the smoke
    script exits non-zero and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the card path is exercised "
                    "by running chip_smoke.py itself")
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(REPO / "chip_smoke.py", alone)
    for script in (REPO / "chip_smoke.py", alone):
        proc = subprocess.run([sys.executable, str(script)],
                              capture_output=True, text=True, timeout=300,
                              cwd=script.parent)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
