"""Serving launcher: batched requests through the port's ServeEngine, on
the CUDA card unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch \\
        deepseek-v2-236b --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch \\
        recurrentgemma-2b --slots 2048

Weights are random, from ``--seed``.  The prompt pass of every request
runs the flash-attention kernel on the card (recurrentgemma-2b: in its
local-attention layers, for prompts up to the 2048-token window).  Token-frontend archs only,
as in the JAX package's launcher (musicgen-medium is fed frame
embeddings: drive its ``Model.prefill`` / ``decode_step`` directly).
"""

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core.state import resolve_device
from repro_torch.models.model import build_model
from repro_torch.serving.engine import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' to run on the CPU")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--lanes", type=int, default=2)
    ap.add_argument("--slots", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = (configs.reduced if args.reduced else configs.full)(args.arch)
    if cfg.frontend != "tokens":
        raise SystemExit("serving demo supports token-frontend archs")
    model = build_model(cfg, device=device)
    params = model.init(torch.Generator(device=device).manual_seed(args.seed))
    engine = ServeEngine(model, params, lanes=args.lanes, slots=args.slots)

    rng = np.random.default_rng(args.seed)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab,
                                        rng.integers(3, 10)).astype(np.int32),
                    max_new=args.max_new)
            for i in range(args.requests)]
    t0 = time.perf_counter()
    done = engine.run(reqs)
    dt = time.perf_counter() - t0
    toks = sum(len(r.out) for r in done)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "CPU")
    for r in done:
        print(f"req {r.rid}: prompt {r.prompt.tolist()} -> {r.out}")
    print(f"[serve] {cfg.name}: {len(done)} requests, {toks} tokens in "
          f"{dt:.2f}s ({toks / dt:.1f} tok/s on {where}, {args.lanes} lanes)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
