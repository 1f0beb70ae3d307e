"""The simple flash kernel (``csrc/flash.cu``) against another version of
its source, on one CUDA card, for an A/B of a change to it.

Builds this checkout's kernel and the other source (``--other``, e.g.
the parent commit's ``flash.cu``, written out with ``git show``), then
at the served models' prefill shapes (B 1, S 1024: tinyllama-1.1b's
H 32 / K 4 / dh 64 in bf16 and float32, qwen2-1.5b's 12 / 2 / 128 and
dbrx-132b's 48 / 8 / 128 in bf16, deepseek-v2-236b's MLA 128 / 128 /
q·k 192, v 128 in bf16; seed 3) holds both outputs bitwise equal (the
arithmetic is the same) and times them in turns (other, tree, tree,
other) x 2: device ms per launch from
``torch.profiler`` (``chip_smoke.device_ms``).  One line per shape, and
the card's name and power limit::

    git show HEAD~1:src/repro_torch/kernels/attention/csrc/flash.cu \\
        > build/flash_other.cu
    python3 scripts/flash_simple_ab.py --other build/flash_other.cu

The other source's ``flash_attention_fwd`` takes this tree's arguments
(``dh`` and ``dv``: the q·k and v head dims).  Needs a card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import sys
from pathlib import Path

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# case, (B, S, H, K, q·k head dim, v head dim), dtype
SHAPES = (("tinyllama-1.1b", (1, 1024, 32, 4, 64, 64), "bfloat16"),
          ("tinyllama-1.1b", (1, 1024, 32, 4, 64, 64), "float32"),
          ("qwen2-1.5b", (1, 1024, 12, 2, 128, 128), "bfloat16"),
          ("dbrx-132b", (1, 1024, 48, 8, 128, 128), "bfloat16"),
          ("deepseek-v2-236b", (1, 1024, 128, 128, 192, 128), "bfloat16"))
TURNS = ("other", "tree", "tree", "other") * 2


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True,
                    help="path of the other version's flash.cu")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch

    if not torch.cuda.is_available():
        print("flash_simple_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.attention import flash as fl

    _build.SOURCES["flash_other"] = Path(args.other).resolve()
    _build.build_all(["flash", "flash_other"])
    lib = _build.load("flash_other")
    P, I, St = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong * 4
    lib.flash_attention_fwd.argtypes = [P, P, P, P, I, I, I, I, I, I, St,
                                        St, St, I, P]
    lib.flash_attention_fwd.restype = I

    def other(q, k, v):
        B, S, H, dh = q.shape
        dv = v.shape[-1]
        out = q.new_empty(B, S, H, dv)
        status = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S,
            H, k.shape[2], dh, dv, St(*q.stride()),
            St(*k.stride()), St(*v.stride()),
            0 if q.dtype == torch.float32 else 1,
            torch.cuda.current_stream().cuda_stream)
        if status:
            raise RuntimeError(f"the other flash kernel: error {status}")
        return out

    fns = {"other": other,
           "tree": lambda q, k, v: fl.flash_attention_cuda(q, k, v,
                                                           kernel="simple")}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    for case, (B, S, H, K, dh, dv), name in SHAPES:
        dt = getattr(torch, name)
        q, k, v = (torch.randn(B, S, n, e, generator=gen, device=dev).to(dt)
                   for n, e in ((H, dh), (K, dh), (K, dv)))
        equal = torch.equal(other(q, k, v), fns["tree"](q, k, v))
        turns = {r: [] for r in fns}
        for r in TURNS:
            fn = fns[r]
            turns[r].append(cs.device_ms(lambda: fn(q, k, v),
                                         kernel="flash_attention_kernel"))
        cs.say("ab", case=case, shape=f"B{B}xS{S}xH{H}xK{K}xdh{dh}xdv{dv}",
               dtype=name, bitwise_equal=equal,
               other_ms=f"{np.mean(turns['other']):.5f}",
               tree_ms=f"{np.mean(turns['tree']):.5f}",
               ratio=f"{np.mean(turns['tree']) / np.mean(turns['other']):.4f}",
               turns_ms={r: [round(t, 5) for t in ts]
                         for r, ts in turns.items()})
        if not equal:
            return 1
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
