#!/usr/bin/env python3
"""The padded Hopper flash route against the simple kernel at every head
dim it admits, on one CUDA card.

    python3 scripts/flash_pad_sweep.py

``flash_kernel_for`` sends an equal head dim d whose row is a multiple
of 16 bytes (bfloat16: d % 8 == 0; float32: d % 4 == 0; d <= 256) to the
Hopper kernel of its type, which runs it in the smallest tile that holds
it, the columns past d zeros.  This script, for every such d in both
types:

1. holds the routed Hopper kernel to the plain version (float32 2e-3,
   bfloat16 3e-2, atol = rtol and of the largest |want|), causal at a
   ragged S 130 and without causality at T 129 and T 1 (one key into the
   last key tile);
2. times it in turns with the simple kernel (``flash.cu``, forced) --
   Hopper, simple, simple, Hopper -- at B 1 x S 1024 x H 8 (K 2), causal,
   by ``torch.profiler`` device time as ``chip_smoke.py`` does;
3. for d <= 32, times the small tiles -- bfloat16's 16 and 32
   (``MIN_TILE`` 16), float32's 32 (``SMALL_TILE`` 32) -- against a build
   of the same source whose constant is 64 (every d <= 64 padded to
   64), in turns, after the same checks.

Prints a line per head dim, then the dims where the Hopper kernel did
not beat the simple one (``flash_kernel_for`` may send a head dim to the
Hopper kernel only where it won) and the dims where a small tile lost
(``MIN_TILE``, ``SMALL_TILE``).  Builds into ``build/repro_torch/`` (the variants under
``pad_variants/``).  Needs a card and nvcc.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(REPO, "src"), REPO]

SHAPE = (1, 1024, 8, 2)     # B, S, H, K of the timing
CHECKS = ((2, 130, 130, True), (1, 65, 129, False), (1, 33, 1, False))
# each Hopper source, the constant that sets its smallest tiles, and its
# entry point
VARIANTS = {"flash_sm90": ("MIN_TILE", "flash_attention_sm90_fwd"),
            "flash_sm90_f32": ("SMALL_TILE", "flash_attention_sm90_f32_fwd")}


def variant_source(text: str, const: str, value: int) -> str:
    """The source with ``value`` for its constant ``const``."""
    text, n = re.subn(rf"constexpr int {const} = \d+;",
                      f"constexpr int {const} = {value};", text)
    assert n == 1
    return text


def start_variant(name: str):
    """Start compiling source ``name`` with its small-tile constant at
    64; ``(process, library)``."""
    from repro_torch.kernels import _build

    out = _build.BUILD_DIR / "pad_variants"
    out.mkdir(parents=True, exist_ok=True)
    src = out / f"{name}_tile64.cu"
    lib = src.with_suffix(".so")
    src.write_text(variant_source(_build.SOURCES[name].read_text(),
                                  VARIANTS[name][0], 64))
    return subprocess.Popen(
        [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib


def load_variant(name: str, path):
    """The variant library's entry point, typed."""
    from repro_torch.kernels.attention import flash as fl

    fn = getattr(ctypes.CDLL(str(path)), VARIANTS[name][1])
    fn.argtypes = [fl._P] * 4 + [fl._I] * 7 + [fl._Strides] * 3 + \
        [fl._I, fl._P]
    fn.restype = fl._I
    return fn


def ptxas_lines(log: str, kernel: str) -> dict:
    """``{"<tile>[-padded]": "N registers, M bytes spill ..."}`` of a
    log's causal instantiations of ``kernel``."""
    out, key = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(kernel + r"ILi(\d+)ELi(\d+)ELb1ELb([01])E", line)
            key = (f"{m.group(1)}x{m.group(2)}"
                   + ("-padded" if m.group(3) == "1" else "")) if m else None
        elif key and "registers" in line:
            out[key] = line.split("Used", 1)[-1].strip()
        elif key and "spill" in line:
            out[key] = out.get(key, "") + "; " + line.strip()
    return out


def main() -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import attention as fa
    from repro_torch.kernels.attention import flash as fl

    if not torch.cuda.is_available():
        print("flash_pad_sweep: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    jobs = {name: start_variant(name) for name in VARIANTS}
    logs = _build.build_all(["flash", "flash_sm90", "flash_sm90_f32"])
    tile64 = {}
    for name, (proc, lib) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}'s variant:\n{log}")
        tile64[name] = load_variant(name, lib)
        cs.say("pad", source=name, variant="tile64",
               ptxas=ptxas_lines(log, cs.FLASH_NAMES[
                   "sm90" if name == "flash_sm90" else "sm90_f32"]))
    cs.say("pad", build_s=f"{time.perf_counter() - t0:.1f}",
           sm90=ptxas_lines(logs["flash_sm90"], cs.FLASH_NAMES["sm90"]),
           sm90_f32=ptxas_lines(logs["flash_sm90_f32"],
                                cs.FLASH_NAMES["sm90_f32"]))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(33)

    def run_tile64(q, k, v, causal=True):
        """The variant build of the type's Hopper kernel: every head dim
        below 64 padded to 64."""
        name = "flash_sm90" if q.dtype == torch.bfloat16 else \
            "flash_sm90_f32"
        out = q.new_empty(q.shape[:-1] + v.shape[-1:])
        dims, strides = fl._args(q, k, v, out)
        status = tile64[name](*dims, v.shape[-1], *strides, int(causal),
                              torch.cuda.current_stream().cuda_stream)
        if status != 0:
            raise RuntimeError(f"{name} (small tiles at 64): error {status}")
        return out

    def run_hopper(q, k, v, causal=True):
        """The routed build of the type's Hopper kernel, whatever the
        route's tables say."""
        out = q.new_empty(q.shape[:-1] + v.shape[-1:])
        launch = (fl.launch_flash_sm90 if q.dtype == torch.bfloat16
                  else fl.launch_flash_sm90_f32)
        launch(q, k, v, out, causal)
        return out

    def inputs(B, S, T, H, K, d, dtype):
        return [torch.randn(*shape, generator=gen, device=dev).to(dtype)
                for shape in ((B, S, H, d), (B, T, K, d), (B, T, K, d))]

    lost = {"bfloat16": [], "float32": []}
    small_lost = []
    for dtype, step in ((torch.bfloat16, 8), (torch.float32, 4)):
        name = str(dtype).split(".")[-1]
        tol = cs.FLASH_TOL[name]
        hopper = "sm90" if dtype == torch.bfloat16 else "sm90_f32"
        for d in range(step, fl.MAX_DH + 1, step):
            small = d <= 32
            for B, S, T, causal in CHECKS:
                q, k, v = inputs(B, S, T, 4, 2, d, dtype)
                want = fa.flash_attention_ref(q, k, v, causal=causal)
                what = f"{name} dh {d} S {S} T {T}"
                cs._flash_err(torch, run_hopper(q, k, v, causal), want, tol,
                              f"{hopper} {what}")
                if small:
                    cs._flash_err(torch, run_tile64(q, k, v, causal), want,
                                  tol, f"tile 64 {what}")
            q, k, v = inputs(*SHAPE[:2], SHAPE[1], *SHAPE[2:], d, dtype)
            route = fa.flash_kernel_for(q, k, v)
            fns = {hopper: (lambda: run_hopper(q, k, v),
                            cs.FLASH_NAMES[hopper]),
                   "simple": (lambda: fa.flash_attention_cuda(
                       q, k, v, kernel="simple"), cs.FLASH_NAMES["simple"])}
            order = (hopper, "simple")
            if small:
                fns["tile64"] = (lambda: run_tile64(q, k, v),
                                 cs.FLASH_NAMES[hopper])
                order += ("tile64",)
            ms = {r: [] for r in order}
            for r in order + order[::-1]:
                fn, kernel = fns[r]
                ms[r].append(cs.device_ms(fn, kernel=kernel))
            mean = {r: sum(t) / len(t) for r, t in ms.items()}
            tile = fl.sm90_tile(dtype, d, d)[0]
            if mean[hopper] >= mean["simple"]:
                lost[name].append(d)
            if small and mean[hopper] >= mean["tile64"]:
                small_lost.append((name, d))
            cs.say("pad", dtype=name, dh=d, tile=tile, route=route,
                   shape=f"B{SHAPE[0]}xS{SHAPE[1]}xH{SHAPE[2]}xK{SHAPE[3]}",
                   **{f"{r}_ms": "/".join(f"{t:.5f}" for t in ts)
                      for r, ts in ms.items()},
                   hopper_over_simple=f"{mean[hopper] / mean['simple']:.4f}")
            del q, k, v
    cs.say("pad", hopper_not_faster=lost, small_tile_not_faster=small_lost)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
