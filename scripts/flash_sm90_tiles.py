#!/usr/bin/env python3
"""Key-tile and ring-depth sweep of the Hopper flash-attention kernel on
one CUDA card.

    python3 scripts/flash_sm90_tiles.py

Builds ``src/repro_torch/kernels/attention/csrc/flash_sm90.cu`` once per
choice of its tile constants (``BK_DH64``, ``BK_DH128``, ``BK_MLA`` /
``STAGES_MLA``, ``BK_DH256`` / ``STAGES_DH256``; the others at the
source's values), all builds at once, into ``build/repro_torch/tiles/``.
Each build is held to the plain version (bfloat16, within 3e-2 of the
largest |want|, and atol = rtol = 3e-2) at its shape and at a ragged S
1000 and a non-causal T 129, and timed in turns (forward, then
backward) beside the simple kernel and ``scaled_dot_product_attention``
at the served prefill shapes: tinyllama-1.1b's (B 1, S 1024, H 32, K 4,
dh 64), qwen2-1.5b's (H 12, K 2, dh 128), deepseek-v2-236b's MLA pass (H
128 = K, q·k 192 / v 128) and recurrentgemma-2b's local layers (H 10, K
1, dh 256).  Prints each build's ``ptxas`` registers and spill at its
head dims and the fastest choice of each shape.  Device times are
``torch.profiler``'s, as in ``chip_smoke.py``.  Needs a card and nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(REPO, "src"), REPO]

# (case, (B, S, H, K, dqk, dv), the choices of the constants it reads)
SWEEPS = (
    ("tinyllama-1.1b", (1, 1024, 32, 4, 64, 64),
     ({"BK_DH64": 64}, {"BK_DH64": 128})),
    ("qwen2-1.5b", (1, 1024, 12, 2, 128, 128),
     ({"BK_DH128": 128}, {"BK_DH128": 64})),
    ("deepseek-v2-236b-mla", (1, 1024, 128, 128, 192, 128),
     ({"BK_MLA": 128, "STAGES_MLA": 2}, {"BK_MLA": 64, "STAGES_MLA": 2},
      {"BK_MLA": 64, "STAGES_MLA": 3})),
    ("recurrentgemma-2b", (1, 1024, 10, 1, 256, 256),
     ({"BK_DH256": 64, "STAGES_DH256": 2},
      {"BK_DH256": 64, "STAGES_DH256": 3},
      {"BK_DH256": 32, "STAGES_DH256": 2},
      {"BK_DH256": 32, "STAGES_DH256": 4})),
)
TOL = 3e-2


def variant(text: str, consts: dict) -> str:
    """The source with ``consts`` in place of its own values."""
    for name, val in consts.items():
        text, n = re.subn(rf"constexpr int {name} = \d+;",
                          f"constexpr int {name} = {val};", text)
        assert n == 1, name
    return text


def start(text: str):
    """Start compiling ``text`` unless built; ``(process, library)``."""
    from repro_torch.kernels import _build

    out = _build.BUILD_DIR / "tiles"
    out.mkdir(parents=True, exist_ok=True)
    tag = hashlib.sha256(text.encode()).hexdigest()[:12]
    src = out / f"flash_sm90_{tag}.cu"
    lib = src.with_suffix(".so")
    if lib.exists():
        return None, lib
    src.write_text(text)
    return subprocess.Popen(
        [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib


def ptxas(log: str, dqk: int, dv: int) -> str:
    """Registers and spill of the causal instantiation at (dqk, dv)."""
    mark, inside, out = f"ILi{dqk}ELi{dv}ELb1E", False, []
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
    lib.flash_attention_sm90_fwd.argtypes = \
        [fl._P] * 4 + [fl._I] * 7 + [fl._Strides] * 3 + [fl._I, fl._P]
    lib.flash_attention_sm90_fwd.restype = fl._I
    return lib


def main() -> int:
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import attention as fa
    from repro_torch.kernels.attention import flash as fl

    if not torch.cuda.is_available():
        print("flash_sm90_tiles: no CUDA device", file=sys.stderr)
        return 2
    text = _build.SOURCES["flash_sm90"].read_text()
    # one build per distinct source: a choice of the source's own values
    # is the source itself
    sources, jobs = {}, {}
    for _, _, choices in SWEEPS:
        for consts in choices:
            src = variant(text, consts)
            sources[tuple(sorted(consts.items()))] = src
            if src not in jobs:
                jobs[src] = start(src)
    _build.build_all(["flash"])
    built = {}
    for src, (proc, path) in jobs.items():
        log = proc.communicate()[0] if proc is not None else ""
        if proc is not None and proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {path.name}:\n{log}")
        built[src] = load(path), log
    libs = {key: built[src][0] for key, src in sources.items()}
    logs = {key: built[src][1] for key, src in sources.items()}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)

    def run(lib, q, k, v, causal=True):
        out = q.new_empty(q.shape[:-1] + v.shape[-1:])
        dims, strides = fl._args(q, k, v, out)
        status = lib.flash_attention_sm90_fwd(
            *dims, v.shape[-1], *strides, int(causal),
            torch.cuda.current_stream().cuda_stream)
        if status != 0:
            raise RuntimeError(f"flash_attention_sm90_fwd: error {status}")
        return out

    def inputs(B, S, T, H, K, dqk, dv):
        return [torch.randn(*shape, generator=gen, device=dev).to(
            torch.bfloat16) for shape in ((B, S, H, dqk), (B, T, K, dqk),
                                          (B, T, K, dv))]

    for case, (B, S, H, K, dqk, dv), choices in SWEEPS:
        keys = [tuple(sorted(c.items())) for c in choices]
        # ragged cases first: S 1000 (causal), T 129 (not)
        for s, t, causal in ((1000, 1000, True), (S, 129, False)):
            q, k, v = inputs(B, s, t, H, K, dqk, dv)
            want = fa.flash_attention_ref(q, k, v, causal=causal)
            for key in keys:
                cs._flash_err(torch, run(libs[key], q, k, v, causal), want,
                              TOL, f"{case} {dict(key)} S {s} T {t}")
            del q, k, v, want
        q, k, v = inputs(B, S, S, H, K, dqk, dv)
        want = fa.flash_attention_ref(q, k, v)
        err = {key: cs._flash_err(torch, run(libs[key], q, k, v), want, TOL,
                                  f"{case} {dict(key)}") for key in keys}
        ms = {key: [] for key in keys}
        for key in keys + keys[::-1]:
            ms[key].append(cs.device_ms(
                lambda: run(libs[key], q, k, v),
                kernel="flash_attention_kernel_sm90"))
        simple_ms = cs.device_ms(
            lambda: fa.flash_attention_cuda(q, k, v, kernel="simple"),
            kernel="flash_attention_kernel")
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        lib_ms = cs.device_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))
        for key in keys:
            cs.say("tiles", case=case,
                   shape=f"B{B}xS{S}xH{H}xK{K}xdqk{dqk}xdv{dv}",
                   **{name.lower(): val for name, val in key},
                   ms="/".join(f"{x:.5f}" for x in ms[key]),
                   mean_ms=f"{sum(ms[key]) / 2:.5f}",
                   max_abs_err=err[key], simple_ms=f"{simple_ms:.5f}",
                   library_ms=f"{lib_ms:.5f}",
                   ptxas=ptxas(logs[key], dqk, dv) or "(built before)")
        best = min(keys, key=lambda c: sum(ms[c]))
        cs.say("tiles", case=case, fastest=str(dict(best)),
               mean_ms=f"{sum(ms[best]) / 2:.5f}")
        del q, k, v, qt, kt, vt, want
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
