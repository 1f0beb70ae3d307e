#!/usr/bin/env python3
"""Collectives a training pass runs under each ``ModelConfig.remat``
policy: the port's counts beside the JAX package's compiled programs.

    python3 scripts/remat_counts.py            # the CPU, ~60 s

The port, on the CPU: one ``Trainer.value_and_grad`` of the island model
of ``tests/test_torch_moe.py`` (2 MoE layers, 8 experts over 4 kernels
x 2 data groups, cf 16; one shared expert and none) for each dispatch,
and of qwen2-smoke under ``seq_shard`` (ring attention over the same
mesh), under none, full and dots: exchanges and collective calls by
kind (``ctx.exchanges``, ``ctx.collectives``).  The JAX package: the
collectives by kind of ``jax.jit(jax.grad(Model.loss))`` on the CPU
mesh ``("data", "model")`` = (2, 4) for the same models (with the
shared expert), from ``tests/test_torch_remat.py``'s reference
subprocess.  One table a case, a row a policy.
"""

import dataclasses
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))
sys.path.insert(0, os.path.join(REPO, "tests"))

import numpy as np  # noqa: E402

POLICIES = ("none", "full", "dots")


def port_counts(case: str, policy: str, shared: int = 1):
    """(exchanges, {kind: calls}) of one value_and_grad on the CPU."""
    import torch

    from repro_torch import configs
    from repro_torch.core.state import ShoalContext
    from repro_torch.models import moe as tmoe
    from repro_torch.models.model import ModelConfig, build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.training import Trainer

    if case == "ring":
        cfg = dataclasses.replace(configs.reduced("qwen2-1.5b"), tp=False,
                                  seq_shard=True, remat=policy)
    else:
        cfg = ModelConfig(
            name="tm", family="moe", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=4, d_ff=128, vocab=128,
            moe=tmoe.MoEDims(n_experts=8, top_k=2, d_ff_expert=64,
                             n_shared=shared, capacity_factor=16.0,
                             dispatch=case),
            dtype=torch.float32, remat=policy)
    ctx = ShoalContext(4, device="cpu")
    model = build_model(cfg, device="cpu", ep=tmoe.ExpertMesh(ctx, data=2))
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (4, 32))
    batch = {"tokens": torch.from_numpy(toks).long(),
             "labels": torch.from_numpy(np.roll(toks, -1, 1)).long()}
    Trainer(model, AdamWConfig()).value_and_grad(
        model.init(torch.Generator().manual_seed(0)), batch)
    return ctx.exchanges, {k: v for k, v in ctx.collectives.items() if v}


def jax_counts() -> dict:
    """{case/policy/kind: count} from the test file's reference run."""
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([os.path.join(REPO, "src"),
                                           os.path.join(REPO, "tests")]))
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "reference.npz")
        subprocess.run([sys.executable, os.path.join(
            REPO, "tests", "test_torch_remat.py"), out], env=env, check=True)
        return {k: int(v) for k, v in np.load(out).items()}


def main() -> int:
    ref = jax_counts()
    for case in ("psum", "rs", "a2a", "ring"):
        print(f"== {case}" + ("" if case == "ring" else
                              " (2 MoE layers, 4 kernels x 2 data groups)"))
        for policy in POLICIES:
            jax = {k.split("/")[-1]: v for k, v in ref.items()
                   if k.startswith(f"{case}/{policy}/")}
            row = [f"{policy:5s}"]
            shared = (1, 0) if case != "ring" else (1,)
            for s in shared:
                ex, calls = port_counts(case, policy, s)
                tag = "" if case == "ring" else f" shared {s}"
                row.append(f"port{tag}: {ex} exchanges {calls}")
            row.append(f"jax: {jax}")
            print(" | ".join(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
