"""The port's launchers (``repro_torch.launch.train``, ``launch.serve``)
through their own ``main(argv)``, on the CPU, at the reduced configs.

* The train launcher's restart does not race its own in-flight
  checkpoint: with every leaf write slowed, a run that fails at step 3
  with a checkpoint every 2 steps still restores step 2 (the attempt
  waits for the write it started) and ends with the checkpoint of an
  uninterrupted run, leaf for leaf (manifest sha256).
* A checkpoint writer that dies makes ``main`` fail (its exception
  raised again), with and without an injected failure, where it used
  to print ``done`` and return 0.
* The serve launcher's printed tokens are ``ServeEngine.run``'s on the
  same seed-0 weights and requests.

``chip_smoke.py``'s phase 20 runs the same checks at full width on the
card (``check_train_launcher``, ``check_serve_launcher``).
"""

import json
import os
import threading
import time

import pytest
import torch

import chip_smoke
from repro_torch import configs
from repro_torch.checkpoint import checkpoint as ck
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models.model import build_model
from repro_torch.serving import ServeEngine

COMMON = ["--reduced", "--device", "cpu", "--steps", "5", "--batch", "4",
          "--seq", "16", "--log-every", "1", "--backend", "shoal",
          "--kernels", "2"]
LEAF_DELAY_S = 0.02         # a write then outlasts several reduced steps


def _manifest(directory, step):
    with open(os.path.join(directory, f"step_{step:08d}",
                           "manifest.json")) as f:
        return json.load(f)


@pytest.fixture
def slow_writer(monkeypatch):
    real = ck._save_leaf

    def slow(path, leaf, dtype):
        time.sleep(LEAF_DELAY_S)
        real(path, leaf, dtype)

    monkeypatch.setattr(ck, "_save_leaf", slow)


def test_restart_restores_the_checkpoint_in_flight(tmp_path, capsys,
                                                   slow_writer):
    crash, straight = str(tmp_path / "crash"), str(tmp_path / "straight")
    assert launch_train.main(COMMON + ["--ckpt-dir", crash, "--fail-at",
                                       "3", "--ckpt-every", "2"]) == 0
    out = capsys.readouterr().out
    wanted = ("[launch] attempt 0 failed: injected failure at step 3",
              "[launch] restored step 2 (data step 2)",
              "[launch] done at step 5")
    assert all(line in out for line in wanted), out
    assert [out.find(line) for line in wanted] == sorted(
        out.find(line) for line in wanted)
    assert launch_train.main(COMMON + ["--ckpt-dir", straight,
                                       "--ckpt-every", "100"]) == 0
    assert "restored" not in capsys.readouterr().out
    a, b = _manifest(crash, 5), _manifest(straight, 5)
    assert a["extras"] == b["extras"] == {"data_step": 5}
    assert [(e["path"], e["sha256"]) for e in a["leaves"]] \
        == [(e["path"], e["sha256"]) for e in b["leaves"]]
    assert sorted(os.listdir(crash)) == ["step_00000002", "step_00000004",
                                         "step_00000005"]


@pytest.mark.parametrize("fail_at", [[], ["--fail-at", "3"]])
def test_a_dead_writer_fails_the_launcher(tmp_path, monkeypatch, fail_at):
    """The background writer dies; the final save, on the launcher's own
    thread, would succeed."""
    real = ck._save_leaf

    def broken(path, leaf, dtype):
        if threading.current_thread() is threading.main_thread():
            return real(path, leaf, dtype)
        raise OSError(28, "No space left on device", path)

    monkeypatch.setattr(ck, "_save_leaf", broken)
    with pytest.raises(OSError, match="No space left"):
        launch_train.main(COMMON + ["--ckpt-dir", str(tmp_path),
                                    "--ckpt-every", "2"] + fail_at)
    assert not [d for d in os.listdir(tmp_path) if not d.endswith(".tmp")]


def test_manager_wait_raises_the_writers_exception(tmp_path, monkeypatch):
    mgr = ck.CheckpointManager(str(tmp_path))

    def broken(path, leaf, dtype):
        raise OSError(5, "Input/output error", path)

    monkeypatch.setattr(ck, "_save_leaf", broken)
    mgr.save_async(1, {"w": torch.ones(3)})
    with pytest.raises(OSError, match="Input/output error"):
        mgr.wait()
    mgr.wait()                      # raised once; nothing pending now
    monkeypatch.undo()
    mgr.save_async(2, {"w": torch.ones(3)})
    mgr.wait()
    assert mgr.all_steps() == [2]


def test_serve_launcher_prints_the_engine_tokens(capsys):
    argv = ["--reduced", "--device", "cpu"]
    assert launch_serve.main(argv) == 0
    got = chip_smoke._printed_tokens(capsys.readouterr().out)
    args = launch_serve.build_parser().parse_args(argv)
    cfg = configs.reduced(args.arch)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(args.seed))
    done = ServeEngine(model, params, lanes=args.lanes,
                       slots=args.slots).run(
        launch_serve.make_requests(cfg, args))
    want = {r.rid: (tuple(r.prompt.tolist()), tuple(r.out)) for r in done}
    assert len(want) == args.requests
    assert all(len(t) == args.max_new for _, t in want.values())
    assert got == want
