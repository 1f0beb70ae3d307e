#!/usr/bin/env python3
"""Device ms of both flash kernels at the served models' causal prefill
shapes, from the ``repro_torch`` of this tree or of another one, for an
A/B of a change to the kernels' causal path on one CUDA card.

    mkdir -p build/parent && git archive HEAD~1 src | tar -x -C build/parent
    python3 scripts/flash_ab.py --src build/parent/src --tag parent
    python3 scripts/flash_ab.py --tag tree

Run one process a side, in turns (parent, tree, tree, parent), in one
call: each process builds its tree's kernels (into that tree's
``build/``) and calls them through that tree's wrapper,
``kernels.attention.flash_attention_cuda(q, k, v)`` (the routed kernel:
a Hopper kernel of the type) and ``kernel="simple"``, so the two trees'
C interfaces may differ.  Shapes (B, S, H, K, q·k dh, v dh; seed 3):
tinyllama-1.1b, qwen2-1.5b, deepseek-7b, dbrx-132b, musicgen-medium and
llama-3.2-vision-90b's self-attention in bf16, deepseek-v2-236b's MLA
192 / 128 and recurrentgemma-2b's dh 256 in bf16; tinyllama, qwen2-1.5b,
deepseek-v2-236b's MLA and recurrentgemma-2b's dh 256 in float32
(``--dtype`` keeps one type).  Device ms per launch from
``torch.profiler`` (``chip_smoke.device_ms``) and a digest of the
output's bytes (equal digests on both sides: bitwise equal outputs);
one line per shape and kernel, and the card's name and power limit.
Needs a card and nvcc.

A variant of one kernel's source is timed the same way: copy the tree,
edit the copy's ``.cu`` and pass the copy's ``src`` as ``--src``.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# case, (B, S, H, K, q·k head dim, v head dim), dtype
SHAPES = (("tinyllama-1.1b", (1, 1024, 32, 4, 64, 64), "bfloat16"),
          ("qwen2-1.5b", (1, 1024, 12, 2, 128, 128), "bfloat16"),
          ("deepseek-7b", (1, 1024, 32, 32, 128, 128), "bfloat16"),
          ("dbrx-132b", (1, 1024, 48, 8, 128, 128), "bfloat16"),
          ("musicgen-medium", (1, 1024, 24, 24, 64, 64), "bfloat16"),
          ("llama-3.2-vision-self", (4, 1024, 64, 8, 128, 128), "bfloat16"),
          ("deepseek-v2-236b", (1, 1024, 128, 128, 192, 128), "bfloat16"),
          ("recurrentgemma-2b", (1, 1024, 10, 1, 256, 256), "bfloat16"),
          ("tinyllama-1.1b", (1, 1024, 32, 4, 64, 64), "float32"),
          ("qwen2-1.5b", (1, 1024, 12, 2, 128, 128), "float32"),
          ("deepseek-v2-236b", (1, 1024, 128, 128, 192, 128), "float32"),
          ("recurrentgemma-2b", (1, 1024, 10, 1, 256, 256), "float32"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(REPO, "src"),
                    help="the src/ directory whose repro_torch to time")
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    help="only the shapes of this type")
    args = ap.parse_args()
    sys.path[:0] = [os.path.abspath(args.src), REPO]
    import torch

    if not torch.cuda.is_available():
        print("flash_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    for case, (B, S, H, K, dh, dv), name in SHAPES:
        if args.dtype not in (None, name):
            continue
        dt = getattr(torch, name)
        q, k, v = (torch.randn(B, S, n, e, generator=gen, device=dev).to(dt)
                   for n, e in ((H, dh), (K, dh), (K, dv)))
        route = fa.flash_kernel_for(q, k, v)
        for kernel in dict.fromkeys((route, "simple")):
            out = fa.flash_attention_cuda(q, k, v, kernel=kernel)
            digest = hashlib.sha1(out.contiguous().view(torch.uint8).cpu()
                                  .numpy().tobytes()).hexdigest()[:16]
            ms = cs.device_ms(
                lambda: fa.flash_attention_cuda(q, k, v, kernel=kernel),
                kernel=cs.FLASH_NAMES[kernel])
            cs.say("flash_ab", tag=args.tag, case=case,
                   shape=f"B{B}xS{S}xH{H}xK{K}xdh{dh}xdv{dv}", dtype=name,
                   kernel=kernel, ms=f"{ms:.5f}", digest=digest)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
