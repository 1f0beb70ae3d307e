#!/usr/bin/env python3
"""Chunk-length sweep of the two ring kernels on one CUDA card.

    python3 scripts/ring_sweep.py

For each schedule of ``kernels/gascore_dma`` (dma, reduce-scatter,
all-gather, all-reduce) on K = 2, 4 and 8 kernels in float32 (and on 8
in bfloat16 and int32), and chunk lengths from 1 word to 1 Mi words,
forces the cluster kernel (``csrc/gascore_dma_sm90.cu``) and the simple
kernel (``csrc/gascore_dma.cu``) on the same input, holds both bitwise
to the plain version, and prints the device time of each in two
profiler windows (cluster then simple, simple then cluster), as
``torch.profiler`` records it (as in ``chip_smoke.py``), with the ratio,
whether the cluster kernel won both turns, and ``ring_kernel_for``'s
route: the measurement behind ``CLUSTER_MIN_K``,
``CLUSTER_MIN_CHUNK_BYTES`` and ``CLUSTER_MAX_CHUNK_BYTES``.  Each ring
runs in a process of its own (``ring_sweep.py K dtype`` runs one).
Needs a card and nvcc.
"""

from __future__ import annotations

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(REPO, "src"), REPO]

RINGS = ((2, "float32"), (4, "float32"), (8, "float32"), (8, "bfloat16"),
         (8, "int32"))
CHUNKS = [1, 64, 256, 1024, 4096, 16384, 65536, 1048576]
WINDOWS = (("sm90", "simple"), ("simple", "sm90"))   # two turns each
NAMES = {"sm90": "ring_cluster_kernel_sm90", "simple": "ring_kernel"}


def turn_ms(torch, cs, fns, order, reps=20, tries=3):
    """Device ms per launch of each kernel in ``order``, from one
    ``torch.profiler`` window that runs ``reps`` calls of each in that
    order; a window in which the profiler missed more than half of a
    kernel's launches is taken again, up to ``tries`` windows."""
    for r in order:
        for _ in range(3):
            fns[r]()
    for _ in range(tries):
        by_name, _ = cs.device_activity(
            torch, lambda: [fns[r]() for r in order for _ in range(reps)])
        seen = {r: [(c, us) for name, (c, us) in by_name.items()
                    if NAMES[r] in name] for r in order}
        if all(reps // 2 <= sum(c for c, _ in v) <= reps
               for v in seen.values()):
            return {r: sum(us for _, us in v) / 1e3 / sum(c for c, _ in v)
                    for r, v in seen.items()}
    raise AssertionError(f"profiler missed the ring kernels in {tries} "
                         "windows")


def sweep(K: int, dtype_name: str) -> None:
    """Every schedule at every chunk length on one ring of K kernels."""
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import gascore_dma as gd

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    dtype = getattr(torch, dtype_name)
    for schedule in (gd.DMA, gd.REDUCE_SCATTER, gd.ALL_GATHER,
                     gd.ALL_REDUCE):
        for c in CHUNKS:
            shape = (K, c) if schedule in (gd.DMA, gd.ALL_GATHER) \
                else (K, K, c)
            if dtype == torch.int32:
                x = torch.randint(-127, 128, shape, generator=gen,
                                  device=dev, dtype=dtype)
            else:
                x = torch.randn(shape, generator=gen, device=dev).to(dtype)
            if schedule == gd.DMA:
                fns = {r: (lambda r=r: gd.ring_allreduce_dma_cuda(x, kernel=r))
                       for r in NAMES}
                want = gd.ring_allreduce_dma_ref(x)
            else:
                fns = {r: (lambda r=r: gd.ring_collective_cuda(
                    x, schedule, kernel=r)) for r in NAMES}
                want = gd.ring_collective_ref(x, schedule)
            for r, fn in fns.items():
                cs.require(torch.equal(fn(), want),
                           f"{r} {schedule} K={K} {dtype} chunk {c}: "
                           "differs from the plain version")
            del want
            ms = {r: [] for r in NAMES}
            for order in WINDOWS:
                for r, t in turn_ms(torch, cs, fns, order).items():
                    ms[r].append(t)
            cs.say("sweep", schedule=schedule, K=K, dtype=dtype_name,
                   chunk_words=c, chunk_bytes=c * dtype.itemsize,
                   sm90_ms="/".join(f"{v:.6f}" for v in ms["sm90"]),
                   simple_ms="/".join(f"{v:.6f}" for v in ms["simple"]),
                   ratio=f"{sum(ms['sm90']) / sum(ms['simple']):.3f}",
                   sm90_wins_both=max(ms["sm90"]) < min(ms["simple"]),
                   route=gd.ring_kernel_for(K, c, dtype, schedule))
            del x


def main() -> int:
    import subprocess

    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("ring_sweep: no CUDA device", file=sys.stderr)
        return 2
    if len(sys.argv) == 3:
        sweep(int(sys.argv[1]), sys.argv[2])
        return 0
    for K, dtype in RINGS:          # a process each: a fresh profiler
        subprocess.run([sys.executable, os.path.abspath(__file__), str(K),
                        dtype], check=True)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
