#!/usr/bin/env python3
"""Precision sweep of the float32 Hopper flash-attention kernel on one
CUDA card.

    python3 scripts/flash_f32_variants.py

Builds ``src/repro_torch/kernels/attention/csrc/flash_sm90_f32.cu`` once
per value of its ``PRECISION`` -- 0: one TF32 pass on both products; 1:
QK^T split into hi·hi + hi·lo + lo·hi, one pass on P·V; 2: both split
-- all builds and the simple kernel (``csrc/flash.cu``) at once, into
``build/repro_torch/f32_variants/``.  Each build is held to the plain
version (float32, ``flash_attention_ref``) within 2e-3 -- atol = rtol
= 2e-3 and 2e-3 of the largest |want|, ``chip_smoke._flash_err``'s rule
-- at the served float32 prompt shapes (tinyllama-1.1b's B 1, S 1024,
H 32, K 4, dh 64; qwen2-1.5b's H 12, K 2, dh 128; deepseek-v2-236b's
MLA pass, H 128 = K, q·k 192 / v 128; recurrentgemma-2b's local layers,
H 10, K 1, dh 256), causal, and at ragged ones (S 1000 and S 7 causal;
T 129 and T 1 without causality).  At each prompt shape the builds, the
simple kernel and ``scaled_dot_product_attention`` in float32 (TF32 off,
the library yardstick) are timed in turns, then in reverse.  Prints
each build's ``ptxas`` registers and spill at each head-dim pair, one
line per build and shape, and the fastest build that held every case.
Device times are ``torch.profiler``'s, as in ``chip_smoke.py``.  Needs
a card and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(REPO, "src"), REPO]

PRECISIONS = (0, 1, 2)
# (case, (B, S, H, K, dqk, dv)): the prompt shapes, causal
SHAPES = (("tinyllama-1.1b", (1, 1024, 32, 4, 64, 64)),
          ("qwen2-1.5b", (1, 1024, 12, 2, 128, 128)),
          ("deepseek-v2-236b-mla", (1, 1024, 128, 128, 192, 128)),
          ("recurrentgemma-2b", (1, 1024, 10, 1, 256, 256)))
# ragged cases at each prompt shape's heads and dims: (B, S, T, causal)
RAGGED = ((1, 1000, 1000, True), (4, 7, 7, True), (1, 256, 129, False),
          (1, 256, 1, False))
TOL = 2e-3


def variant(text: str, precision: int) -> str:
    """The source with ``precision`` in place of its own value."""
    text, n = re.subn(r"constexpr int PRECISION = \d+;",
                      f"constexpr int PRECISION = {precision};", text)
    assert n == 1
    return text


def start(text: str, precision: int):
    """Start compiling ``text``; ``(process, library)``."""
    from repro_torch.kernels import _build

    out = _build.BUILD_DIR / "f32_variants"
    out.mkdir(parents=True, exist_ok=True)
    src = out / f"flash_sm90_f32_p{precision}.cu"
    lib = src.with_suffix(".so")
    src.write_text(text)
    return subprocess.Popen(
        [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib


def ptxas(log: str, dqk: int, dv: int) -> str:
    """Registers and spill of the causal instantiation at its own (dqk, dv)
    (not the padded one)."""
    mark, inside, out = f"ILi{dqk}ELi{dv}ELb1ELb0E", False, []
    for line in log.splitlines():
        if "Compiling entry function" in line:
            inside = mark in line
        elif inside and ("registers" in line or "spill" in line):
            out.append(line.split("Used", 1)[-1].strip()
                       if "registers" in line else line.strip())
    return "; ".join(out)


def load(path) -> ctypes.CDLL:
    from repro_torch.kernels.attention import flash as fl

    lib = ctypes.CDLL(str(path))
    lib.flash_attention_sm90_f32_fwd.argtypes = \
        [fl._P] * 4 + [fl._I] * 7 + [fl._Strides] * 3 + [fl._I, fl._P]
    lib.flash_attention_sm90_f32_fwd.restype = fl._I
    lib.flash_sm90_f32_error_string.argtypes = [fl._I]
    lib.flash_sm90_f32_error_string.restype = ctypes.c_char_p
    lib.flash_sm90_f32_precision.restype = fl._I
    return lib


def main() -> int:
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import attention as fa
    from repro_torch.kernels.attention import flash as fl

    if not torch.cuda.is_available():
        print("flash_f32_variants: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line(), flush=True)
    text = _build.SOURCES["flash_sm90_f32"].read_text()
    jobs = {p: start(variant(text, p), p) for p in PRECISIONS}
    _build.build_all(["flash"])
    libs, logs, failed = {}, {}, []
    for p, (proc, path) in jobs.items():
        logs[p] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {path.name}:\n{logs[p]}")
        else:
            libs[p] = load(path)
            assert libs[p].flash_sm90_f32_precision() == p
    if failed:
        print("\n".join(failed), file=sys.stderr)
        return 1
    for p in PRECISIONS:
        for _, (_, _, _, _, dqk, dv) in SHAPES:
            cs.say("f32", precision=p, head_dims=f"{dqk}/{dv}",
                   ptxas=ptxas(logs[p], dqk, dv))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(41)

    def run(p, q, k, v, causal=True):
        out = q.new_empty(q.shape[:-1] + v.shape[-1:])
        dims, strides = fl._args(q, k, v, out)
        status = libs[p].flash_attention_sm90_f32_fwd(
            *dims, v.shape[-1], *strides, int(causal),
            torch.cuda.current_stream().cuda_stream)
        if status != 0:
            raise RuntimeError(
                f"precision {p}: error {status} "
                f"({libs[p].flash_sm90_f32_error_string(status).decode()})")
        return out

    def inputs(B, S, T, H, K, dqk, dv):
        return [torch.randn(*shape, generator=gen, device=dev)
                for shape in ((B, S, H, dqk), (B, T, K, dqk), (B, T, K, dv))]

    def err(got, want):
        """max |err|, and whether it holds _flash_err's limits."""
        torch.cuda.synchronize()
        diff = (got - want).abs()
        top = want.abs().max().item()
        e = diff.max().item()
        ok = (bool(torch.isfinite(got).all())
              and (diff - TOL * want.abs()).max().item() <= TOL
              and e <= TOL * top)
        return e, ok

    held = {p: True for p in PRECISIONS}
    summary = []
    for case, (B, S, H, K, dqk, dv) in SHAPES:
        for b, s, t, causal in RAGGED:
            q, k, v = inputs(b, s, t, H, K, dqk, dv)
            want = fa.flash_attention_ref(q, k, v, causal=causal)
            line = {}
            for p in PRECISIONS:
                e, ok = err(run(p, q, k, v, causal), want)
                held[p] &= ok
                line[f"p{p}_max_abs_err"] = e
                line[f"p{p}_held"] = ok
            cs.say("f32", case=case, check="ragged",
                   shape=f"B{b}xS{s}xT{t}xH{H}xK{K}xdqk{dqk}xdv{dv}",
                   causal=causal, tol=TOL, **line)
            del q, k, v, want
        q, k, v = inputs(B, S, S, H, K, dqk, dv)
        want = fa.flash_attention_ref(q, k, v)
        errs = {p: err(run(p, q, k, v), want) for p in PRECISIONS}
        for p, (_, ok) in errs.items():
            held[p] &= ok
        simple_err = err(fa.flash_attention_cuda(q, k, v, kernel="simple"),
                         want)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        fns = {p: (lambda p=p: run(p, q, k, v),
                   "flash_attention_kernel_sm90_f32") for p in PRECISIONS}
        fns["simple"] = (lambda: fa.flash_attention_cuda(
            q, k, v, kernel="simple"), "flash_attention_kernel")
        fns["library"] = (lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), None)
        order = list(fns)
        ms = {r: [] for r in order}
        for r in order + order[::-1]:
            fn, kernel = fns[r]
            ms[r].append(cs.device_ms(fn, kernel=kernel))
        mean = {r: sum(v) / len(v) for r, v in ms.items()}
        ops = B * H * S * S * (dqk + dv)
        nbytes = 4 * (q.numel() + k.numel() + v.numel() + want.numel())
        for p in PRECISIONS:
            tf32_ms = ops * (1 if p == 0 else 2 if p == 1 else 3) \
                / 495e12 * 1e3
            rec = dict(case=case, precision=p,
                       shape=f"B{B}xS{S}xH{H}xK{K}xdqk{dqk}xdv{dv}",
                       max_abs_err=errs[p][0], held=errs[p][1],
                       ms=mean[p], turns_ms=ms[p], simple_ms=mean["simple"],
                       simple_max_abs_err=simple_err[0],
                       library_ms=mean["library"],
                       tf32_bound_ms=max(tf32_ms, nbytes / 3.35e12 * 1e3),
                       ffma_floor_ms=ops / 67e12 * 1e3,
                       ptxas=ptxas(logs[p], dqk, dv))
            summary.append(rec)
            cs.say("f32", **{key: (f"{val:.5f}" if isinstance(val, float)
                                   and key.endswith("ms") else val)
                             for key, val in rec.items()
                             if key != "turns_ms"},
                   turns_ms=json.dumps([round(x, 5) for x in ms[p]]))
        cs.say("f32", case=case, simple_turns_ms=json.dumps(
            [round(x, 5) for x in ms["simple"]]),
            library_turns_ms=json.dumps([round(x, 5)
                                         for x in ms["library"]]))
        del q, k, v, qt, kt, vt, want
    fastest = [p for p in sorted(
        PRECISIONS, key=lambda p: sum(r["ms"] for r in summary
                                      if r["precision"] == p)) if held[p]]
    cs.say("f32", held=json.dumps({str(p): ok for p, ok in held.items()}),
           fastest_held=fastest[0] if fastest else None)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
