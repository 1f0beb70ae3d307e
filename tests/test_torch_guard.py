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
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 15
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
    table = hd.HandlerTable()
    hid = table.register("twice", lambda r, p: r + 2 * p)
    assert hid == hd.NUM_BUILTIN and not table.builtin_only
    seg = torch.zeros(1, 8, device="meta")
    i32 = torch.zeros(1, 1, dtype=torch.int32, device="meta")
    with pytest.raises(NotImplementedError, match="later slice"):
        dm.datamover_scatter(seg, torch.zeros(1, 1, 4, device="meta"), i32,
                             i32, i32, i32, table)
    ctx = ShoalContext(2, segment_words=16, device="cpu", handlers=table)
    st = GlobalAddressSpace(ctx).make_global_state(np.ones(32, np.float32))
    st = ops.put_long(ctx, st, torch.full((2, 4), 3.0), [(0, 1), (1, 0)],
                      dst_addr=2, handler=hid, token=1)
    np.testing.assert_array_equal(st.segment[:, 2:6].numpy(),
                                  np.full((2, 4), 7.0))


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
