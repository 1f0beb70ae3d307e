#!/usr/bin/env python3
"""Key-tile sweep of the Hopper flash-attention kernel on one CUDA card.

    python3 scripts/flash_sm90_tiles.py

Builds ``src/repro_torch/kernels/attention/csrc/flash_sm90.cu`` once per
choice of key tile (``BK_DH64``, ``BK_DH128`` in {64, 128}) into
``build/repro_torch/tiles/``, holds each build to the plain version
(bfloat16, atol = rtol = 3e-2) and prints the device time of each, in
turns (forward, then backward), beside ``scaled_dot_product_attention``
at tinyllama-1.1b's prefill (B 1, S 1024, H 32, K 4, dh 64) and
qwen2-1.5b's (B 1, S 1024, H 12, K 2, dh 128).  Device times are
``torch.profiler``'s, as in ``chip_smoke.py``.  Needs a card and nvcc.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(REPO, "src"), REPO]

SHAPES = [(1, 1024, 32, 4, 64), (1, 1024, 12, 2, 128)]
TILES = [(64, 128), (128, 64), (64, 64), (128, 128)]   # (dh 64, dh 128)


def build(text: str, tiles) -> ctypes.CDLL:
    from repro_torch.kernels import _build
    from repro_torch.kernels.attention import flash as fl

    for name, bk in zip(("BK_DH64", "BK_DH128"), tiles):
        text, n = re.subn(rf"{name} = \d+;", f"{name} = {bk};", text)
        assert n == 1, name
    out = _build.BUILD_DIR / "tiles"
    out.mkdir(parents=True, exist_ok=True)
    src = out / f"flash_sm90_{tiles[0]}_{tiles[1]}.cu"
    src.write_text(text)
    lib_path = src.with_suffix(".so")
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path),
                    str(src)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.flash_attention_sm90_fwd.argtypes = \
        [fl._P] * 4 + [fl._I] * 6 + [fl._Strides] * 3 + [fl._I, fl._P]
    lib.flash_attention_sm90_fwd.restype = fl._I
    return lib


def main() -> int:
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.attention import flash as fl
    from repro_torch.kernels.attention.ref import flash_attention_ref

    if not torch.cuda.is_available():
        print("flash_sm90_tiles: no CUDA device", file=sys.stderr)
        return 2
    text = _build.SOURCES["flash_sm90"].read_text()
    libs = {t: build(text, t) for t in TILES}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)

    def run(lib, q, k, v):
        out = torch.empty_like(q)
        dims, strides = fl._args(q, k, v, out)
        status = lib.flash_attention_sm90_fwd(
            *dims, *strides, 1, torch.cuda.current_stream().cuda_stream)
        if status != 0:
            raise RuntimeError(f"flash_attention_sm90_fwd: error {status}")
        return out

    for B, S, H, K, dh in SHAPES:
        q, k, v = cs._flash_inputs(torch, gen, dev, B, S, H, K, dh,
                                   torch.bfloat16)
        want = flash_attention_ref(q, k, v)
        ms = {t: [] for t in TILES}
        for t in TILES + TILES[::-1]:
            cs._flash_err(torch, run(libs[t], q, k, v), want, 3e-2,
                          f"tiles {t}")
            ms[t].append(cs.device_ms(lambda: run(libs[t], q, k, v),
                                      kernel="flash_attention_kernel_sm90"))
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        lib_ms = cs.device_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))
        for t, m in ms.items():
            cs.say("tiles", shape=f"B{B}xS{S}xH{H}xK{K}xdh{dh}",
                   bk_dh64=t[0], bk_dh128=t[1],
                   ms="/".join(f"{x:.5f}" for x in m),
                   library_ms=f"{lib_ms:.5f}")
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
