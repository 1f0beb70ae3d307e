#!/usr/bin/env python3
"""How far a rounding difference grows through xlstm-350m's sLSTM.

    python3 scripts/xlstm_chaos.py               # on the CUDA card
    python3 scripts/xlstm_chaos.py --device cpu  # the one-block parts

At the JAX package's init an sLSTM block's recurrent weights ``r`` have
scale 0.25 (fan-in over the 4 heads, times 0.5), so at d 1024 (head dim
256) the recurrence gains ~4 a step and is chaotic.  Three measurements,
float32, seeded:

1. one sLSTM block at d 64, 256 and 1024, 512 tokens: the output's
   change, relative to its largest |value|, after the input is scaled by
   1 + 1e-6, at positions 0 ... 511;
2. the same block at d 1024: the largest |input gradient| by position,
   for an output gradient of scale 1e-3 (how far a gradient grows back
   through the loop);
3. on the card only: xlstm-350m at full width and depth (bf16, seed 0),
   one trainer member's gradient of ``Model.loss`` on 2 rows of
   ``TokenPipeline``'s batch at 64, 128, 192, 256 and 512 tokens: its
   largest finite |gradient| and the words that are not finite.

Prints one line per measurement, with the card's name and power limit.
"""

import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

import torch  # noqa: E402

from repro_torch.core.state import resolve_device  # noqa: E402
from repro_torch.models import xlstm as xl  # noqa: E402

POSITIONS = (0, 16, 32, 64, 128, 256, 384, 511)


def card_line(device) -> str:
    if device.type != "cuda":
        return "CPU"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def perturbation_growth(d, device, S=512):
    gen = torch.Generator(device=device).manual_seed(0)
    p = xl.init_slstm(gen, d, 4)
    x = torch.randn(1, S, d, generator=gen, device=device)
    with torch.no_grad():
        a, _ = xl.slstm_block(p, x, nh=4)
        b, _ = xl.slstm_block(p, x * (1 + 1e-6), nh=4)
    rel = (a - b)[0].abs().amax(-1) / a[0].abs().amax(-1)
    return {t: f"{rel[t].item():.1e}" for t in POSITIONS}


def gradient_growth(d, device, S=512):
    gen = torch.Generator(device=device).manual_seed(0)
    p = xl.init_slstm(gen, d, 4)
    x = torch.randn(1, S, d, generator=gen, device=device,
                    requires_grad=True)
    out, _ = xl.slstm_block(p, x, nh=4)
    out.backward(torch.randn(out.shape, generator=gen, device=device)
                 * 1e-3)
    g = x.grad[0].abs().amax(-1)
    return {t: f"{g[t].item():.1e}" for t in POSITIONS}


def trainer_gradients(device, seqs=(64, 128, 192, 256, 512)):
    from repro_torch import configs
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.models.model import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.training import Trainer
    from repro_torch.tree import tree_paths

    cfg = configs.full("xlstm-350m")
    model = build_model(cfg, device=device)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    tr = Trainer(model, AdamWConfig(lr=1e-3))
    for seq in seqs:
        batch, _ = TokenPipeline(DataConfig(vocab=cfg.vocab, batch=8,
                                            seq=seq, seed=0),
                                 device=device).next_batch(0)
        rows = {k: v[:2] for k, v in batch.items()}
        t = time.perf_counter()
        loss, grads = tr.value_and_grad(params, rows)
        leaves = [g for _, g in tree_paths(grads)]
        bad = sum(int((~torch.isfinite(g)).sum()) for g in leaves)
        top = max(g.float().nan_to_num(0, 0, 0).abs().max().item()
                  for g in leaves)
        print(f"[xlstm-chaos] trainer_member_gradient seq={seq} rows=2 "
              f"loss={loss.item():.5f} largest_finite_abs={top:.3e} "
              f"not_finite_words={bad} "
              f"seconds={time.perf_counter() - t:.2f}", flush=True)
        del grads, leaves


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' for the one-block "
                         "parts on the CPU")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line(device)
    print(f"[xlstm-chaos] device={card} torch={torch.__version__}",
          flush=True)
    for d in (64, 256, 1024):
        print(f"[xlstm-chaos] slstm_perturbation_1e-6 d={d} "
              f"rel_change_by_position={perturbation_growth(d, device)}",
              flush=True)
    print(f"[xlstm-chaos] slstm_input_gradient d=1024 out_grad_scale=1e-3 "
          f"by_position={gradient_growth(1024, device)}", flush=True)
    if device.type == "cuda":
        trainer_gradients(device)
    print(f"[xlstm-chaos] card={card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
