"""Training launcher: a checkpointed, fault-tolerant step loop, on the
CUDA card unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        --backend shoal --kernels 4 --steps 100 --batch 8 --seq 512
    PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch musicgen-medium \\
        --reduced --device cpu --backend shoal --steps 4
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch llama-3.2-vision-90b --reduced --device cpu --steps 4
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch recurrentgemma-2b --reduced --device cpu --steps 4

The same flags and loop as the JAX package's launcher: the data
pipeline's step inside the checkpoint, asynchronous checkpoints off the
critical path, restore-on-restart (running the same command again
resumes), retry-on-failure with bounded restarts (``--fail-at`` injects
failures), and the comm backend.  ``--kernels`` is the ``shoal``
backend's data-parallel member count (the JAX launcher takes it from
the device mesh).  Weights are random, from ``--seed``.
"""

import argparse
import os
import sys
import tempfile
import time

import torch

from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.state import resolve_device
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.training.elastic import FailureInjector
from repro_torch.training.train import Trainer, TrainerConfig


def make_parts(args):
    device = resolve_device(args.device)
    cfg = (configs.reduced if args.reduced else configs.full)(args.arch)
    model = build_model(cfg, device=device)
    opt = AdamWConfig(lr=warmup_cosine(args.lr, args.warmup, args.steps))
    trainer = Trainer(model, opt,
                      TrainerConfig(comm_backend=args.backend,
                                    microbatches=args.microbatches),
                      kernels=args.kernels)
    dcfg = DataConfig(
        vocab=cfg.vocab, batch=args.batch, seq=args.seq, seed=args.seed,
        kind="embeddings" if cfg.frontend == "embeddings" else "tokens",
        d_model=cfg.d_model,
        image_tokens=cfg.n_image_tokens if cfg.family == "vlm" else 0)
    pipe = TokenPipeline(dcfg, device=device)
    return cfg, model, trainer, pipe


def train_once(args, injector=None):
    """One launcher attempt: restore if possible, run to args.steps."""
    cfg, model, trainer, pipe = make_parts(args)
    mgr = CheckpointManager(args.ckpt_dir, keep=3)
    step_fn = trainer.make_train_step()

    state = trainer.init_state(
        torch.Generator(device=model.device).manual_seed(args.seed))
    dstep = pipe.init_state()
    if mgr.latest_step() is not None:
        state, extras = mgr.restore(state)
        dstep = extras["data_step"]
        print(f"[launch] restored step {int(state.step)} "
              f"(data step {dstep})", flush=True)

    t_last = time.time()
    while int(state.step) < args.steps:
        if injector is not None:
            injector.check(int(state.step))
        batch, dstep = pipe.next_batch(dstep)
        state, metrics = step_fn(state, batch)
        s = int(state.step)
        if s % args.log_every == 0:
            dt = time.time() - t_last
            t_last = time.time()
            print(f"[train] step {s:5d} loss {float(metrics['loss']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"({dt / args.log_every:.2f}s/step)", flush=True)
        if s % args.ckpt_every == 0:
            mgr.save_async(s, state, extras={"data_step": dstep})
    mgr.wait()
    mgr.save(int(state.step), state, extras={"data_step": dstep})
    return state


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced same-family config (CPU-scale)")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' to run on the CPU")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend", default="xla", choices=["xla", "shoal"])
    ap.add_argument("--kernels", type=int, default=4,
                    help="data-parallel members of the shoal backend")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--max-restarts", type=int, default=3)
    ap.add_argument("--fail-at", type=int, nargs="*", default=[],
                    help="inject failures at these steps (fault-tolerance demo)")
    args = ap.parse_args(argv)
    resolve_device(args.device)     # no card is no node failure: raise now

    injector = FailureInjector(set(args.fail_at)) if args.fail_at else None
    for attempt in range(args.max_restarts + 1):
        try:
            state = train_once(args, injector)
            print(f"[launch] done at step {int(state.step)}")
            return 0
        except RuntimeError as e:   # node failure
            print(f"[launch] attempt {attempt} failed: {e}; restarting "
                  f"from last checkpoint", flush=True)
    print("[launch] exceeded max restarts", file=sys.stderr)
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
