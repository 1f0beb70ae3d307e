"""Serving's host cost on the card, for an A/B of two trees of the port.

Loads tinyllama-1.1b at full width and depth (bf16, random weights from
seed 0) into a ``ServeEngine`` of 4 lanes and 2048 slots, as
``chip_smoke.py`` phase 6 serves it, and prints one JSON line:

* ``prefill_ms``: host ms of each synchronised ``submit`` of four
  prompts (1024, 903, 512 and 128 tokens from seed 0);
* ``decode_ms``: host ms of each synchronised ``step`` with all four
  lanes busy, their median and their least (the host clock's spread
  on a shared host is wide; the least is its floor);
* ``aten_ops_per_decode_step``: the aten operations one step dispatches.

Give ``--src`` the ``src`` directory of the tree to measure (default:
this checkout's); ``--reduced --device cpu`` checks the script on the
2-layer tinyllama-smoke off the card.  Compare two trees only within
one call on the card, in turns (A, B, B, A), one process each::

    python3 scripts/serving_ab.py --src PARENT/src --tag parent
    python3 scripts/serving_ab.py --tag change
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPTS = (1024, 903, 512, 128)
LANES, SLOTS = 4, 2048
STEPS = 64                  # decode steps timed


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--tag", default="")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true",
                    help="tinyllama-smoke: the script checked off the card")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch import configs
    from repro_torch.models.model import build_model
    from repro_torch.serving import Request, ServeEngine

    device = torch.device(args.device)
    cuda = device.type == "cuda"
    if cuda and not torch.cuda.is_available():
        print("serving_ab: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip() if cuda else "cpu"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    class CountOps(TorchDispatchMode):
        count = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.count += 1
            return func(*args, **(kwargs or {}))

    cfg = (configs.reduced if args.reduced else configs.full)(
        "tinyllama-1.1b")
    model = build_model(cfg, device=device)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in PROMPTS]
    # warm-up on an engine of its own: the kernels' libraries, cuBLAS
    ServeEngine(model, params, lanes=1, slots=SLOTS).run(
        [Request(-1, prompts[-1], 2)])
    engine = ServeEngine(model, params, lanes=LANES, slots=SLOTS)
    endless = 10 ** 9

    def timed(fn):
        sync()
        t = time.perf_counter()
        fn()
        sync()
        return (time.perf_counter() - t) * 1e3

    prefill = [timed(lambda: engine.submit(Request(i, p, endless)))
               for i, p in enumerate(prompts)]
    with CountOps() as mode:
        engine.step()
    decode = [timed(engine.step) for _ in range(STEPS)]
    print(json.dumps({
        "tag": args.tag, "card": card, "src": os.path.abspath(args.src),
        "prefill_tokens": list(PROMPTS),
        "prefill_ms": [round(v, 3) for v in prefill],
        "decode_ms": [round(v, 3) for v in decode],
        "decode_ms_median": round(float(np.median(decode)), 4),
        "decode_ms_min": round(min(decode), 4),
        "aten_ops_per_decode_step": mode.count}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
