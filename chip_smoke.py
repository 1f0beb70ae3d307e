#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from the sources in this checkout,
holds each against its plain PyTorch version on the card (both DataMover
designs -- the Hopper one, ``am_pack_sm90.cu``, and the simple one,
``am_pack.cu`` -- bitwise, in float32, int32 and bfloat16, timed in turns
beside an empty kernel's launch floor), drives the
paper's microbenchmark ops on 8 kernels, then runs the paper's Jacobi
application at its footnote-2 size (4096 x 4096 grid, 8 kernels, TCP
with 9000-byte frames so every halo row is segmented, 1024 iterations)
through ``JacobiApp``, checks it against the single-grid reference and
profiles a 64-iteration window of it (device busy time, idle share).
Phase 5 drives the ring collectives and the GAScore's RDMA ring on 8
kernels at the width of tinyllama-1.1b's embedding gradient (8 x
32000*2048 words, the data-parallel trainer's largest leaf), at 1 MB,
at its 2048-word norm leaf and a 1-word scale, holds them to float64
sums, each call's ring kernel (the cluster kernel ``gascore_dma_sm90.cu``
or the simple ``gascore_dma.cu``, by ``ring_kernel_for``) to the launch
counters, and both ring kernels to their plain version bitwise, times
them beside the library call in turns, and times HUMboldt's two-sided
send/recv beside an acked one-sided put.
Phase 7 drives the rest of Shoal's message layer on 8 kernels: a
vectored put of 34 x 64-word blocks (f32 and bf16, acked and async),
the reliable put of 16 x 2250 words a kernel over a lossy ring (0 / 1 /
5 % drop, duplicates, corruption) and bench_faults.py's 16-word put,
1024 four-word mailbox sends in one flush, a grouped MultiMailbox flush
and a ReplyMailbox over 4 puts; each run on the card bitwise equal to
the same program on the CPU, at the reference's exchange counts; then
both DataMover designs at each of those shapes against the plain
version, timed in turns.
Phase 6 serves tinyllama-1.1b at full width and depth (22 layers,
bfloat16, random weights from a seed) through ``ServeEngine`` -- 4
lanes, 2048 slots, 8 requests of 128-1024 prompt tokens and 32 new
tokens each, greedy -- whose prompt passes run the Hopper flash-attention
kernel (``flash_sm90.cu``: TMA tile ring, ``wgmma``; every launch counted).
It holds that kernel and the simple one (``flash.cu``, which serves
float32 and other head dims) to their plain version on the same inputs,
at tinyllama-1.1b's and qwen2-1.5b's prefill shapes and two ragged
lengths, holds one prefill's logits (bfloat16 through the Hopper kernel,
the same weights in float32 through the simple one) to the same prefill
with the plain version in the kernel's place, and profiles a prefill and
a window of decode steps (device busy time, idle share).
Phase 8 serves the same model through the disaggregated tier: 2 prefill
and 2 decode kernels, 2 lanes each, every finished prefill's KV cache
moved to a decode lane as ONE vectored put into the decode kernel's
segment (2 exchanges), driven through ``ServeFrontend`` with a queue of
2; the landed lanes bitwise the prefill workers', the tokens bitwise
those of a twin run without the migration; then both DataMover designs
at the migration's shapes (the packet's egress, its ragged blocks, their
scatter) against the plain version, timed in turns.
Phase 9 trains tinyllama-1.1b at full width and depth (bfloat16, random
weights from a seed) with the data-parallel trainer's ``shoal`` backend:
4 members on the kernel axis, ``TokenPipeline``'s first batch of 8 x 512
tokens, AdamW; every gradient leaf through the ring kernel (12 launches,
72 exchanges a step, every reduced row bitwise equal); the first batch's
gradients held to the ``xla`` backend's; 5 steps with falling finite
losses, each backend timed, one step timed by part and one profiled;
then at 2 layers one int8-compressed step (int32 ring sums exact) and a
checkpoint round trip (step 3 bitwise).
Phase 10 runs shoal-lint (``repro_torch.analysis``) over the port's main
paths on the card: every registry entry (Jacobi at 1 and 4 iterations,
the 1024-send mailbox flush, a KV migration, the reliable put) clean,
within its ``comm_budgets.toml`` bound, and its events, exchanges and
result bitwise the CPU run's; the R1-R4 probes giving the CPU's
findings and landing the CPU's bits (a waived aliasing vectored put on
the Hopper scatter); the Jacobi footnote-2 run linted over 8
iterations (2 * 8 + 2 exchanges) and phase 8's full-width migration
linted (2 exchanges); the recorder's cost per Jacobi iteration, off and
on in turns, and the aten operations per iteration, off equal to
phase 4's.
Phase 11 runs the dense and audio families at full width (bfloat16,
random weights from a seed): qwen2-1.5b (qkv bias, tied embeddings,
dh 128) and deepseek-7b (MHA, dh 128, ~13.8 GB) served through
``ServeEngine`` as phase 6 serves tinyllama-1.1b, every prompt pass of
every layer on the Hopper flash kernel (8 x 28 and 8 x 30 launches
required) and one prefill's logits held to the plain version;
musicgen-medium fed 4 x 1024 seeded frame embeddings through
``Model.prefill`` and 32 decode steps of frames (48 launches); then the
shoal trainer of qwen2-1.5b and musicgen-medium at full depth and of
deepseek-7b at 4 of its 30 layers, each held to the xla backend on the
first batch, every ring result bitwise the plain ring's, the exchanges
the JAX package's compiled count, the losses finite and falling.
Phase 12 runs the MoE family: dbrx-132b at full width (d 6144, 48 / 8
heads, 16 experts top-4) and 4 of its 40 layers (bf16, random weights
from a seed, 28.5 GB) served through ``ServeEngine`` as phase 6 serves
tinyllama-1.1b, its MoE on one device, every prompt pass of every layer
on the Hopper flash kernel (8 x 4 launches required) and one prefill's
logits held to the plain version; then one full-width MoE layer as the
expert-parallel island over 4 kernels (the psum, rs and a2a dispatches
on the ring kernel and the vectored all-to-all) against ``moe_ffn`` on
the card, at each dispatch's exchange, collective-call and ring-launch
counts, and the ring at the island's shapes against the library call.
Phase 13 runs multi-head latent attention (MLA): both flash kernels
alone at deepseek-v2's prefill shape (B 1 x S 1024 x 128 heads, q·k
head dim 192, v head dim 128, bf16, routed to the Hopper kernel) and at
ragged shapes (S 1000, S 7, causal=False over T 129) against their plain
version, timed in turns beside ``scaled_dot_product_attention`` (right
after phase 6); then
deepseek-v2-236b at full width (d 5120, 128 heads, a 512-word latent KV
cache, 160 experts top-6 and 2 shared) and 4 of its 60 layers (26.6 GB)
served through ``ServeEngine`` as phase 6 serves tinyllama-1.1b, every
prompt pass of every layer on the Hopper flash kernel (8 x 4 launches
required, none of the simple kernel), every decode step in the absorbed
form; one prefill's logits held to the plain version, one absorbed
decode step to the materialized one, and the psum island on its first
MoE layer (shared experts added outside it) to ``moe_ffn``.
Phase 14 runs cross-attention: both flash kernels with ``causal=False``
alone at llama-3.2-vision's cross-attention prompt shape (B 4 x S 1024
text tokens x 64 heads (K 8) over T 1600 image tokens, dh 128, bf16) and
at ragged key lengths (T 1000, T 129, T 1, S 7, and float32 on the
simple kernel) against their plain version (within the tolerance, and
within it of the largest output), timed beside
``scaled_dot_product_attention`` with the self-attention layers' causal
shape (right after phase 6); then llama-3.2-vision-90b at full width
(d 8192, 64 / 8 heads, d_ff 28672) and 10 of its 100 layers (two
superblocks of 4 dense + 1 cross, 21.3 GB, every gate opened from a
seed) fed 4 x 1600 seeded image features: one prefill of 4 x 1024
tokens (10 Hopper flash launches required, 2 of them non-causal) and 32
decode steps re-attending the features (none); the prefill's logits
and the first cross layer's output held to the plain version.
Phase 15 runs the hybrid family: both flash kernels alone at
recurrentgemma-2b's local-attention prompt shape (B 1 x S 1024 x 10
query heads over 1 kv head at head dim 256; bf16 routed to the Hopper
kernel, float32 to the simple one, four threads a query row) and at
ragged shapes (S 1000, S 7, causal=False over T 129) against their
plain version, timed in turns beside
``scaled_dot_product_attention`` (right after phase 14's flash check);
then recurrentgemma-2b at full width and depth (26 layers: RG-LRU blocks
and, every third layer, local attention over a 2048-token window; 3.34 B
parameters, 6.7 GB) served through ``ServeEngine`` as phase 6 serves
tinyllama-1.1b, every prompt pass of each of the 8 local layers on the
Hopper kernel (8 x 8 launches required, none of the simple kernel); one
prefill's logits held to the plain version; a 2040-token prompt decoded
32 steps through the ring's wrap against the windowed forward pass; a
profiled prefill and decode window; then the shoal trainer at one
superblock (3 layers, full width), its losses finite and falling.
Kernel times are device times from ``torch.profiler``.  One line per
phase; any failure raises and the script exits non-zero.
The last two lines are a JSON object with every kernel's numbers and
``{"ok": true, "device": {...}}``.  Needs one CUDA card and ``nvcc``;
without a card it exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(REPO, "src")

HBM_BPS = 3.35e12          # H100 SXM device memory rate (data sheet)
F32_FLOPS = 67e12          # H100 SXM float32 rate outside the tensor cores
BF16_FLOPS = 989e12        # H100 SXM dense bfloat16 tensor-core rate
JACOBI_N, JACOBI_K, JACOBI_ITERS = 4096, 8, 1024
PROFILE_ITERS = 64         # iterations in the profiled Jacobi window
MTU_WORDS = 2250           # 9000-byte frame / 4-byte words
SEG_WORDS = 4 * MTU_WORDS + 64
K = 8
RING = [(i, (i + 1) % K) for i in range(K)]
LEAF_WORDS = 32000 * 2048  # tinyllama-1.1b's embedding (vocab x d_model)
MB_WORDS = 32768           # bench_throughput.py's 1 MB ring payload
NORM_WORDS = 2048          # tinyllama-1.1b's RMSNorm gain (d_model)
HUM_BYTES = (8, 512, 4096)  # bench_latency.py's message sizes
RING_SRC = "src/repro_torch/kernels/gascore_dma/csrc/gascore_dma.cu"
RING_SM90_SRC = "src/repro_torch/kernels/gascore_dma/csrc/gascore_dma_sm90.cu"
RING_TPU = "src/repro/kernels/gascore_dma/gascore_dma.py:62"
FLASH_SRC = "src/repro_torch/kernels/attention/csrc/flash.cu"
FLASH_SM90_SRC = "src/repro_torch/kernels/attention/csrc/flash_sm90.cu"
FLASH_TPU = "src/repro/kernels/attention/flash.py:80"
ARCH = "tinyllama-1.1b"
LANES, SLOTS, REQUESTS, MAX_NEW = 4, 2048, 8, 32
PROMPT_MIN, PROMPT_MAX = 128, 1024
# the reference's flash tolerances (tests/test_kernels.py:109)
FLASH_TOL = {"float32": 2e-3, "bfloat16": 3e-2}
# kernel vs its plain version through a whole prefill, relative to the
# largest |logit|: the reduced model's bfloat16 tolerance, and the
# reference's float32 flash tolerance
LOGIT_TOL = {"bfloat16": 3e-2, "float32": 2e-3}


def say(phase: str, **kv) -> None:
    items = " ".join(f"{k}={v}" for k, v in kv.items())
    print(f"[{phase}] {items}", flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def call_ms(fn, reps: int = 50, warmup: int = 5) -> float:
    """Mean time in ms of one call of ``fn`` over ``reps`` back-to-back
    calls, by CUDA events, after ``warmup`` calls.  Where a call's device
    work is shorter than its host work (argument checks, dispatch, the
    launch itself) this is host time, not device time."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_activity(torch, fn):
    """Run ``fn`` under ``torch.profiler``; return ``{name: [count,
    device us]}`` of every device activity it caused (kernels, copies,
    fills) and the host-clock seconds of the window, which ends with a
    device synchronisation."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    by_name = {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        entry = by_name.setdefault(evt.key, [0, 0.0])
        entry[0] += evt.count
        entry[1] += getattr(evt, "self_device_time_total", None) \
            or getattr(evt, "self_cuda_time_total", 0.0)
    return by_name, window


def device_ms(fn, reps: int = 20, warmup: int = 3, kernel=None,
              windows: int = 6) -> float:
    """Device time in ms per call of ``fn``, from the device time that
    ``torch.profiler`` records over ``reps`` calls.  With ``kernel``,
    ``fn`` launches that kernel once per call and the result is the mean
    over the launches the profiler saw of device kernels whose name
    holds that string (the profiler may miss one at a window's edge; it
    must see at least half); without it, every device activity of the
    calls counts, divided by ``reps``.  A window in which the profiler
    recorded too little (it can drop a whole window's activities) is
    taken again after a pause, up to ``windows`` windows."""
    import torch

    for _ in range(warmup):
        fn()

    def calls():
        for _ in range(reps):
            fn()

    for window in range(1, windows + 1):
        by_name, _ = device_activity(torch, calls)
        if kernel is None:
            if by_name:
                return sum(us for _, us in by_name.values()) / 1e3 / reps
            seen = 0
        else:
            seen = sum(c for name, (c, _) in by_name.items() if kernel in name)
            if reps // 2 <= seen <= reps:
                return sum(us for name, (_, us) in by_name.items()
                           if kernel in name) / 1e3 / seen
        say("profile", window=window, kernel=kernel, launches_seen=seen,
            activities=len(by_name), retry=window < windows)
        time.sleep(0.5)
    raise AssertionError(f"profiler recorded too little device activity in "
                         f"{windows} windows of {reps} calls "
                         f"(kernel={kernel})")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _lanes(torch, addr, nwords, seg_words, W, active=None):
    """Flat indices (into a flattened ``(K, seg_words)`` tensor) of every
    lane a DataMover call moves, and the ``(K, B, W)`` lane mask."""
    lanes = torch.arange(W, device=addr.device)
    idx = addr[..., None].long() + lanes
    mask = (lanes < nwords[..., None]) & (idx >= 0) & (idx < seg_words)
    if active is not None:
        mask &= active[..., None] != 0
    base = torch.arange(addr.shape[0], device=addr.device)[:, None, None]
    return (base * seg_words + idx)[mask], mask


def _times(m) -> dict:
    """The phase line's times: device ms of the kernel, its plain version
    and the library call, and the kernel wrapper's call ms."""
    return dict(kernel_ms=f"{m['ms']:.5f}", plain_ms=f"{m['plain']:.5f}",
                library_ms=f"{m['lib']:.5f}", call_ms=f"{m['call']:.5f}")


# the DataMover's two designs: kernel name in the profiler, launch counter
DM_KERNELS = {"gather": {"sm90": "gather_sm90_kernel",
                         "simple": "gather_kernel"},
              "scatter": {"sm90": "scatter_sm90_kernel",
                          "simple": "scatter_kernel"}}
DM_COUNTERS = {("gather", "sm90"): "datamover_gather_sm90",
               ("gather", "simple"): "datamover_gather",
               ("scatter", "sm90"): "datamover_scatter_sm90",
               ("scatter", "simple"): "datamover_scatter"}
DM_SRC = {"sm90": "src/repro_torch/kernels/am_pack/csrc/am_pack_sm90.cu",
          "simple": "src/repro_torch/kernels/am_pack/csrc/am_pack.cu"}
DM_TPU = {"gather": "src/repro/kernels/am_pack/am_pack.py:41",
          "scatter": "src/repro/kernels/am_pack/am_pack.py:58"}
DM_TURNS = ("sm90", "simple", "simple", "sm90")


def _bits(torch, t):
    return t.view({4: torch.int32, 2: torch.int16}[t.element_size()])


def _dm_designs(torch, dtype):
    """The designs that move ``dtype``: the simple one 32-bit words only."""
    return ("sm90", "simple") if dtype in (torch.float32, torch.int32) \
        else ("sm90",)


def floor_ms(torch, device) -> float:
    """Device ms of an empty kernel launched like a DataMover kernel: the
    launch floor the DataMover's times are read against."""
    import importlib

    dmm = importlib.import_module("repro_torch.kernels.am_pack.am_pack")
    return device_ms(lambda: dmm.launch_empty_sm90(device),
                     kernel="empty_sm90_kernel")


def _dm_time(torch, op, fns, designs, device, lib, plain, call, floor=None,
             order=DM_TURNS):
    """Device ms of each design in turns (``order``: Hopper, simple,
    simple, Hopper), of the empty kernel (unless ``floor`` gives it),
    the plain version and the library call, and the routed wrapper's
    call ms."""
    turns = {r: [] for r in designs}
    for r in order:
        if r in designs:
            turns[r].append(device_ms(fns[r], kernel=DM_KERNELS[op][r]))
    return dict(turns_ms=turns,
                design_ms={r: float(np.mean(v)) for r, v in turns.items()},
                floor=floor_ms(torch, device) if floor is None else floor,
                plain=plain, lib=lib, call=call_ms(call))


def _dm_say(op, what, shape, route, m, **extra):
    design = m["design_ms"]
    other = {r: v for r, v in design.items() if r != route}
    say("kernels", kernel=f"datamover_{op}", case=what, shape=shape,
        route=route, bitwise="equal", **extra,
        kernel_ms=f"{design[route]:.5f}",
        other_design_ms=json.dumps({r: round(v, 6) for r, v in
                                    other.items()}),
        floor_ms=f"{m['floor']:.5f}", plain_ms=f"{m['plain']:.5f}",
        library_ms=f"{m['lib']:.5f}", call_ms=f"{m['call']:.5f}",
        bound_ms=f"{m['nbytes'] / HBM_BPS * 1e3:.7f}")


def check_gather(torch, dm, src, addr, nwords, W, what, floor=None,
                 order=DM_TURNS):
    """Both gather designs against the plain version (bitwise), then the
    device times of each design in turns, the empty kernel, the plain
    version and one indexing call (``src[idx]``)."""
    K, B = addr.shape
    route = dm.datamover_kernel_for("gather", K, B, W, src.dtype)
    designs = _dm_designs(torch, src.dtype)
    want = dm.datamover_gather_ref(src, addr, nwords, W)
    for r in designs:
        got = dm.datamover_gather_cuda(src, addr, nwords, W, kernel=r)
        torch.cuda.synchronize()
        require(torch.equal(_bits(torch, got), _bits(torch, want)),
                f"gather {what} ({r}): "
                f"{int((_bits(torch, got) != _bits(torch, want)).sum())} "
                "words differ bitwise")
    flat, _ = _lanes(torch, addr, nwords, src.shape[1], W)
    flat_src = src.reshape(-1)
    # every lane inside the segment is read (a lane past nwords is the
    # word there times 0); each source word counts once towards the
    # bytes bound, however many rows read it
    S = src.shape[1]
    idx = addr[..., None].long() + torch.arange(W, device=addr.device)
    base = torch.arange(K, device=addr.device)[:, None, None] * S
    touched = torch.zeros(K * S, dtype=torch.bool, device=src.device)
    touched[(base + idx)[(idx >= 0) & (idx < S)]] = True
    read = int(touched.sum())
    del idx, base, touched
    elt = src.element_size()
    fns = {r: (lambda r=r: dm.datamover_gather_cuda(src, addr, nwords, W,
                                                    kernel=r))
           for r in designs}
    m = _dm_time(torch, "gather", fns, designs, src.device,
                 lib=device_ms(lambda: flat_src[flat]),
                 plain=device_ms(lambda: dm.datamover_gather_ref(
                     src, addr, nwords, W)),
                 call=lambda: dm.datamover_gather_cuda(src, addr, nwords, W),
                 floor=floor, order=order)
    # in-segment words read once, addr/nwords read, rows written
    m.update(err=0.0, route=route, ms=m["design_ms"][route], case=what,
             nbytes=read * elt + 2 * addr.numel() * 4 + want.numel() * elt)
    _dm_say("gather", what, tuple(want.shape), route, m,
            dtype=str(src.dtype).split(".")[-1])
    return m


def check_gather_masked(torch, dm, seg, i32):
    """Both gather designs against the plain version, bitwise, where the
    lanes past ``nwords`` hold NaN, +-inf and negative words: all
    multiply every lane by its mask, so a masked NaN or inf reads NaN
    and a masked negative -0.0."""
    seg = seg.clone()
    seg[:, 0::5] = float("nan")
    seg[:, 1::5] = float("inf")
    seg[:, 2::5] = -float("inf")
    seg[:, 3::5] = -seg[:, 3::5].abs() - 1
    addr = i32([[b * MTU_WORDS + 3 * k for b in range(4)] for k in range(K)])
    nwords = i32([[(b * 700 + k * 97) % MTU_WORDS for b in range(4)]
                  for k in range(K)])
    want = dm.datamover_gather_ref(seg, addr, nwords, MTU_WORDS)
    neg_zero = -2 ** (8 * seg.element_size() - 1)
    for r in _dm_designs(torch, seg.dtype):
        got = dm.datamover_gather_cuda(seg, addr, nwords, MTU_WORDS, kernel=r)
        torch.cuda.synchronize()
        bits_got, bits_want = _bits(torch, got), _bits(torch, want)
        require(torch.equal(bits_got, bits_want),
                f"gather masked lanes ({r}, {seg.dtype}): "
                f"{int((bits_got != bits_want).sum())} words differ bitwise")
        nan = int(got.isnan().sum())
        zeros = int((bits_got == neg_zero).sum())
        require(nan > 0 and zeros > 0, "masked lanes: no NaN or -0.0 seen")
        say("kernels", kernel="datamover_gather", case="masked-nan-inf",
            design=r, dtype=str(seg.dtype).split(".")[-1],
            shape=tuple(got.shape), bitwise="equal", nan_lanes=nan,
            neg_zero_lanes=zeros)


def check_scatter(torch, dm, seg, pay, addr, nwords, handler, active, what,
                  floor=None, order=DM_TURNS, plain_reps=5):
    """Both scatter designs against the plain version (bitwise), then the
    device times of each design in turns, the empty kernel, the plain
    version and one ``index_put_`` of the same lanes."""
    K, B, W = pay.shape
    route = dm.datamover_kernel_for("scatter", K, B, W, seg.dtype)
    designs = _dm_designs(torch, seg.dtype)
    want = dm.datamover_scatter_ref(seg.clone(), pay, addr, nwords, handler,
                                    active)
    for r in designs:
        got = dm.datamover_scatter_cuda(seg.clone(), pay, addr, nwords,
                                        handler, active, kernel=r)
        torch.cuda.synchronize()
        require(torch.equal(_bits(torch, got), _bits(torch, want)),
                f"scatter {what} ({r}): "
                f"{int((_bits(torch, got) != _bits(torch, want)).sum())} "
                "words differ bitwise")
    flat, mask = _lanes(torch, addr, nwords, seg.shape[1], W, active)
    vals = pay[mask]
    work = seg.clone()
    flat_seg = work.reshape(-1)
    rmw = bool(((handler > 1) & (active != 0)).any())   # add/max/min read
    elt = seg.element_size()
    fns = {r: (lambda r=r: dm.datamover_scatter_cuda(
        work, pay, addr, nwords, handler, active, kernel=r))
        for r in designs}
    m = _dm_time(torch, "scatter", fns, designs, seg.device,
                 lib=device_ms(lambda: flat_seg.index_put_((flat,), vals)),
                 plain=device_ms(lambda: dm.datamover_scatter_ref(
                     work, pay, addr, nwords, handler, active),
                     reps=plain_reps, warmup=min(plain_reps, 3)),
                 call=lambda: dm.datamover_scatter_cuda(
                     work, pay, addr, nwords, handler, active), floor=floor,
                 order=order)
    # payload words read, segment words written (and read for
    # read-modify-write handlers), four (K, B) int32 tables read
    m.update(err=0.0, route=route, ms=m["design_ms"][route], case=what,
             nbytes=int(mask.sum()) * elt * (3 if rmw else 2)
             + 4 * addr.numel() * 4)
    _dm_say("scatter", what, tuple(pay.shape), route, m,
            dtype=str(seg.dtype).split(".")[-1])
    return m


def phase_kernels(torch, device):
    """Every kernel on the card against its plain version; returns the
    entries of the JSON line, measured at the shapes the Jacobi run
    gives each kernel."""
    import torch.nn.functional as F

    from repro_torch.kernels import am_pack as dm
    from repro_torch.kernels import jacobi as jk

    gen = torch.Generator(device="cpu").manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen).to(device=device,
                                                     dtype=dtype)

    def i32(rows):
        return torch.tensor(rows, dtype=torch.int32, device=device)

    # -- gather at the shapes of the microbenchmark puts and gets, both
    #    designs (DataMover numbers by case, for the JSON records) -------
    dmc = {"gather": {}, "scatter": {}}
    seg = randn(K, SEG_WORDS)
    starts = [0, MTU_WORDS, 2 * MTU_WORDS, 3 * MTU_WORDS]
    full = i32([[MTU_WORDS] * 4] * K)
    dmc["gather"]["ops"] = check_gather(
        torch, dm, seg, i32([starts] * K), full, MTU_WORDS, "get_medium-4seg")
    check_gather(torch, dm, seg.to(torch.bfloat16), i32([starts] * K), full,
                 MTU_WORDS, "get_medium-4seg-bf16")
    check_gather(torch, dm, randn(K, 4 * MTU_WORDS), i32([starts] * K), full,
                 MTU_WORDS, "put_long-4seg")
    check_gather(torch, dm, randn(K, MTU_WORDS), i32([[0]] * K),
                 i32([[MTU_WORDS]] * K), MTU_WORDS, "put_long-1seg")
    check_gather(torch, dm, seg, i32([[SEG_WORDS - 100, -5]] * K),
                 i32([[MTU_WORDS, 50]] * K), MTU_WORDS, "ragged-edges")
    check_gather_masked(torch, dm, seg, i32)
    check_gather_masked(torch, dm, seg.to(torch.bfloat16), i32)

    # -- scatter: disjoint and aliasing strides, every built-in handler --
    for dtype in (torch.float32, torch.int32, torch.bfloat16):
        for stride, what in ((80, "disjoint"), (24, "aliasing")):
            B, W = 40, 64
            check_scatter(
                torch, dm, (randn(K, SEG_WORDS) * 8).to(dtype),
                (randn(K, B, W) * 8).to(dtype),
                i32([[100 + b * stride for b in range(B)]] * K),
                i32([[W - (b % 3) for b in range(B)]] * K),
                i32([[(b + k) % 5 for b in range(B)] for k in range(K)]),
                i32([[int((b * 7 + k) % 6 != 0) for b in range(B)]
                     for k in range(K)]),
                f"{what}-{str(dtype).split('.')[-1]}")
    # the ops phase's aliasing strided put as its ingress lands it: two
    # packets of 35 blocks of 64 words, 40 of them live, stride 24
    B, W = 70, 64
    dmc["scatter"]["ops"] = check_scatter(
        torch, dm, randn(K, SEG_WORDS), randn(K, B, W),
        i32([[4900 + 24 * b for b in range(B)]] * K), i32([[W] * B] * K),
        i32([[1] * B] * K), i32([[int(b < 40) for b in range(B)]] * K),
        "strided-ingress-70x64")

    # -- the DataMover at the Jacobi run's shapes (JSON numbers): the up
    #    halo put, whose senders are kernels 1..7 and receivers 0..6 ----
    n, rows = JACOBI_N, JACOBI_N // JACOBI_K
    W, tail = MTU_WORDS, JACOBI_N - MTU_WORDS
    sends = [0] + [1] * (K - 1)
    for dtype in (torch.float32, torch.bfloat16):
        label = "" if dtype == torch.float32 else "-bf16"
        g = check_gather(torch, dm, randn(K, n, dtype=dtype),
                         i32([[0, W]] * K),
                         i32([[W * s, tail * s] for s in sends]), W,
                         "jacobi-halo-egress" + label)
        sc = check_scatter(torch, dm, randn(K, 2 * n, dtype=dtype),
                           randn(K, 2, W, dtype=dtype),
                           i32([[n, n + W]] * K), i32([[W, tail]] * K),
                           i32([[1, 1]] * K),
                           i32([[s, s] for s in sends[::-1]]),
                           "jacobi-halo-ingress" + label)
        if dtype == torch.float32:
            dmc["gather"]["jacobi"], dmc["scatter"]["jacobi"] = g, sc

    # -- Jacobi: full grid f32 / bf16 and the banded form ----------------
    weight = torch.tensor([[0.0, 0.25, 0.0], [0.25, 0.0, 0.25],
                           [0.0, 0.25, 0.0]], device=device)[None, None]
    x = randn(n, n)
    for dtype, tol in ((torch.float32, 1e-6), (torch.bfloat16, 2e-2)):
        xd = x.to(dtype)
        got, want = jk.jacobi_step(xd), jk.jacobi_step_ref(xd)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        require(err <= tol, f"jacobi full {dtype}: max|err| {err} > {tol}")
        x4, w4 = xd[None, None], weight.to(dtype)
        say("kernels", kernel="jacobi_sweep", case=f"full-{n}x{n}-{dtype}",
            max_abs_err=err, tol=tol, **_times(dict(
                ms=device_ms(lambda: jk.jacobi_step(xd),
                             kernel="jacobi_kernel"),
                call=call_ms(lambda: jk.jacobi_step(xd), reps=20),
                plain=device_ms(lambda: jk.jacobi_step_ref(xd)),
                lib=device_ms(lambda: F.conv2d(x4, w4)))))
    pad = randn(K, rows + 2, n)
    out_pad = torch.zeros_like(pad)
    got = jk.jacobi_band_step(pad, out_pad[:, 1:-1])
    want = jk.jacobi_band_ref(pad)
    torch.cuda.synchronize()
    b_err = (got - want).abs().max().item()
    require(b_err <= 1e-6, f"jacobi band: max|err| {b_err}")
    pad4 = pad[:, None]
    def band_kernel():
        return jk.jacobi_band_step(pad, out_pad[:, 1:-1])

    band = dict(
        err=b_err,
        ms=device_ms(band_kernel, kernel="jacobi_kernel"),
        call=call_ms(band_kernel, reps=20),
        plain=device_ms(lambda: jk.jacobi_band_ref(pad)),
        lib=device_ms(lambda: F.conv2d(pad4, weight, padding=(0, 1))),
        # the padded bands read once, the bands written once; 4 float32
        # operations per cell
        nbytes=K * (rows + 2) * n * 4 + K * rows * n * 4,
        ops=4 * K * rows * n)
    say("kernels", kernel="jacobi_sweep", case=f"band-{K}x{rows + 2}x{n}",
        max_abs_err=b_err, **_times(band))

    return {
        "jacobi_sweep": entry(
            "jacobi_sweep", "src/repro_torch/kernels/jacobi/csrc/jacobi.cu",
            "src/repro/kernels/jacobi/jacobi.py:48", band),
    }, dmc


def dm_records(dmc, paths, shapes=None):
    """One JSON record for every DataMover kernel the main paths launched
    (``paths``: launches by path -- ops, jacobi, messages, lint -- and
    counter), measured at the Jacobi
    run's shape if Jacobi launched it, else at the ops phase's; with
    the other design's time in the same call and the launch floor."""
    records = []
    for (op, design), name in DM_COUNTERS.items():
        per_path = {p: c.get(name, 0) for p, c in paths.items()}
        launches = per_path["ops"] + per_path["jacobi"] \
            + per_path["messages"] + per_path.get("lint", 0)
        if not launches:
            continue
        case = "jacobi" if per_path["jacobi"] else "ops"
        m = dmc[op][case]
        rec = entry(name, DM_SRC[design], DM_TPU[op],
                    dict(m, ms=m["design_ms"][design]))
        rec.update(launches=launches, path_launches=per_path,
                   case=m["case"], main_path_route=m["route"],
                   sm90_ms=m["design_ms"].get("sm90"),
                   simple_ms=m["design_ms"].get("simple"),
                   floor_ms=m["floor"], turns_ms=m["turns_ms"])
        # the message layer's shapes that route to this design
        rec["message_shapes"] = [
            {"case": ms["case"], "ms": ms["design_ms"][design],
             "other_design_ms": {r: v for r, v in ms["design_ms"].items()
                                 if r != design},
             "plain_ms": ms["plain"], "library_ms": ms["lib"],
             "bound_ms": bound(ms)[0]}
            for (o, _), ms in (shapes or {}).items()
            if o == op and ms["route"] == design]
        records.append(rec)
    return records


def bound(m):
    """The least time the card could take for a kernel's work, in ms,
    and what sets it: bytes over the memory rate, or operations over
    the rate of their type."""
    t_bytes = m["nbytes"] / HBM_BPS * 1e3
    t_ops = m.get("ops", 0) / m.get("rate", F32_FLOPS) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def entry(name, source, replaces, m):
    """One kernel's record of the JSON line (launches filled in later)."""
    bound_ms, bound_by = bound(m)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0, "max_abs_err": m["err"],
            "ms": m["ms"], "plain_ms": m["plain"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": m["lib"]}


# ---------------------------------------------------------------------------
# phase 3: the paper's microbenchmark ops on 8 kernels
# ---------------------------------------------------------------------------

def phase_ops(torch, device):
    """put_long acked/async at 1 and 4 segments, an H_ADD put, a 4-segment
    get_medium, strided puts, barrier and waits, each against its
    closed-form result and its exchange count.  Returns the launches of
    the get_medium call (the DataMover's get service), by counter."""
    from repro_torch.core import handlers as hd
    from repro_torch.core import ops
    from repro_torch.core.address_space import GlobalAddressSpace
    from repro_torch.core.state import ShoalContext
    from repro_torch.kernels import launch_counts
    from repro_torch.runtime import TCP, UDP

    mtu_words, seg_words = MTU_WORDS, SEG_WORDS
    rng = np.random.default_rng(1)
    pred = [(k - 1) % K for k in range(K)]
    succ = [(k + 1) % K for k in range(K)]
    tcp = dataclasses.replace(TCP, max_packet_bytes=4 * mtu_words)
    udp = dataclasses.replace(UDP, max_packet_bytes=4 * mtu_words)
    ctx = ShoalContext(K, tcp, seg_words, device=device)
    uctx = ShoalContext(K, udp, seg_words, device=device)
    st = GlobalAddressSpace(ctx).make_global_state()
    want = np.zeros((K, seg_words), np.float32)
    words = 0

    def dev(a):
        return torch.from_numpy(a).to(device)

    def exch(c, before, n, what):
        require(c.exchanges - before == n,
                f"{what}: {c.exchanges - before} exchanges, expected {n}")

    for nseg in (1, 4):
        p = rng.standard_normal((K, nseg * mtu_words)).astype(np.float32)
        before = ctx.exchanges
        st = ops.put_long(ctx, st, dev(p), RING, dst_addr=0, token=1)
        exch(ctx, before, 2, f"put_long acked {nseg}seg")
        require(bool((st.credits[:, 1] == 1).all()), "acked put: one credit")
        st = ops.wait_replies(ctx, st, 1, 1)
        want[:, :p.shape[1]] = p[pred]
        words += p.shape[1]
        before = uctx.exchanges
        q = rng.standard_normal((K, nseg * mtu_words)).astype(np.float32)
        st = ops.put_long(uctx, st, dev(q), RING, dst_addr=0,
                          asynchronous=True)
        exch(uctx, before, 1, f"put_long async {nseg}seg")
        want[:, :q.shape[1]] = q[pred]
        words += q.shape[1]
        say("ops", op=f"put_long-{nseg}seg", acked_exchanges=2,
            async_exchanges=1)

    ones = np.ones((K, mtu_words), np.float32)
    st = ops.put_long(ctx, st, dev(ones), RING, dst_addr=0,
                      handler=hd.H_ADD, token=2)
    st = ops.wait_replies(ctx, st, 2, 1)
    want[:, :mtu_words] += 1
    words += mtu_words

    before, counts = ctx.exchanges, launch_counts()
    st, got = ops.get_medium(ctx, st, RING, src_addr=0,
                             nwords=4 * mtu_words, token=3)
    get_service = {k: v - counts[k] for k, v in launch_counts().items()
                   if v != counts[k]}
    exch(ctx, before, 2, "get_medium 4seg")
    st = ops.wait_replies(ctx, st, 3, 1)
    require(np.array_equal(got.cpu().numpy(), want[succ, :4 * mtu_words]),
            "get_medium data")
    words += 4 * mtu_words
    say("ops", op="get_medium-4seg", exchanges=2)

    blk, nblocks, base = 64, 40, 4900
    for stride in (100, 24):
        p = rng.standard_normal((K, blk * nblocks)).astype(np.float32)
        st = ops.put_long_strided(ctx, st, dev(p), RING, base, stride,
                                  blk_words=blk, nblocks=nblocks, token=4)
        st = ops.wait_replies(ctx, st, 4, 1)
        for i in range(nblocks):            # blocks land in order
            want[:, base + i * stride:base + i * stride + blk] = \
                p[pred][:, i * blk:(i + 1) * blk]
        words += blk * nblocks
        say("ops", op=f"put_long_strided-stride{stride}", blk_words=blk,
            nblocks=nblocks)

    st = ops.barrier(ctx, st)
    seg = st.segment.cpu().numpy()
    require(np.array_equal(seg, want), "segments differ from closed form")
    require(bool((st.credits == 0).all()), "credits not drained")
    require(bool((st.error == 0).all()), "error word set")
    require(bool((st.barrier_epoch == 1).all()), "barrier epoch")
    require(bool((st.tx_words == words).all())
            and bool((st.rx_words == words).all()),
            f"tx/rx words {st.tx_words.tolist()} {st.rx_words.tolist()}, "
            f"expected {words}")
    say("ops", segments="closed-form", credits=0, error=0, words=words,
        get_service_launches=json.dumps(get_service))
    return get_service


# ---------------------------------------------------------------------------
# phase 4: the Jacobi application at the paper's footnote-2 size
# ---------------------------------------------------------------------------

def phase_jacobi(torch, device, n=JACOBI_N, kernels=JACOBI_K,
                 iters=JACOBI_ITERS):
    from repro_torch.apps.jacobi import JacobiApp, jacobi_reference
    from repro_torch.core.address_space import GlobalAddressSpace
    from repro_torch.kernels import launch_counts, reset_launch_counts

    rng = np.random.default_rng(0)
    grid = rng.standard_normal((n, n)).astype(np.float32)
    app = JacobiApp(n=n, kernels=kernels, iters=iters, device=device)
    st = GlobalAddressSpace(app.ctx).make_global_state()
    blocks = torch.from_numpy(grid).reshape(kernels, n // kernels, n).to(
        device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    st, out = app.run_blocks(st, blocks)
    if device.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    ref = jacobi_reference(grid, iters, device=device)
    err = float(np.abs(out.cpu().numpy().reshape(n, n) - ref).max())
    require(err < 1e-5, f"jacobi vs reference: max|err| {err}")
    require(app.ctx.exchanges == 2 * iters + 2,
            f"jacobi exchanges {app.ctx.exchanges} != {2 * iters + 2}")
    require(bool((st.credits == 0).all()) and bool((st.error == 0).all()),
            "jacobi final credits/error not zero")
    if device.type == "cuda":
        require(counts["jacobi_sweep"] >= iters, f"jacobi launches {counts}")
        require(counts["datamover_gather_sm90"] > 0
                and counts["datamover_scatter_sm90"] > 0,
                f"Hopper DataMover launches {counts}")
    say("jacobi", grid=f"{n}x{n}", kernels=kernels, iters=iters,
        max_abs_err=err, exchanges=app.ctx.exchanges,
        ms_per_iter=f"{seconds * 1e3 / iters:.4f}", launches=counts)
    ops_per_iter = None
    if device.type == "cuda":
        ops_per_iter = profile_jacobi(torch, device, blocks)
    return counts, ops_per_iter


def count_ops_mode():
    """A dispatch mode that counts the aten operations run inside it."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class CountOps(TorchDispatchMode):
        count = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.count += 1
            return func(*args, **(kwargs or {}))

    return CountOps


def jacobi_ops_per_iter(torch, device, blocks, recording=False):
    """The aten operations one iteration of the Jacobi run on ``blocks``
    dispatches: a count over runs of 1 and 3 iterations, differenced
    (each run on a fresh app), optionally under a lint recorder."""
    import contextlib

    from repro_torch.analysis import record
    from repro_torch.apps.jacobi import JacobiApp
    from repro_torch.core.address_space import GlobalAddressSpace

    kernels, rows, n = blocks.shape
    CountOps = count_ops_mode()
    dispatched = []
    for k_iters in (1, 3):
        app = JacobiApp(n=n, kernels=kernels, iters=k_iters, device=device)
        st = GlobalAddressSpace(app.ctx).make_global_state()
        with CountOps() as mode, (record() if recording
                                  else contextlib.nullcontext()):
            app.run_blocks(st, blocks)
        dispatched.append(mode.count)
    return (dispatched[1] - dispatched[0]) / 2


def profile_jacobi(torch, device, blocks, iters=PROFILE_ITERS):
    """Where an iteration of the Jacobi run goes, on its configuration:
    the aten operations it dispatches (:func:`jacobi_ops_per_iter`), and
    over one profiled window of ``iters`` iterations its host-clock ms,
    the device's busy ms (self device time of every device activity,
    also by name) and the device's idle share ``1 - busy / window`` --
    busy time and window from the same run.  Returns the aten operations
    per iteration."""
    from repro_torch.apps.jacobi import JacobiApp
    from repro_torch.core.address_space import GlobalAddressSpace

    kernels, rows, n = blocks.shape
    ops_per_iter = jacobi_ops_per_iter(torch, device, blocks)

    def fresh(k_iters):
        app = JacobiApp(n=n, kernels=kernels, iters=k_iters, device=device)
        return app, GlobalAddressSpace(app.ctx).make_global_state()

    app, st = fresh(iters)
    app.run_blocks(st, blocks)                      # builds the ctx tables
    st = GlobalAddressSpace(app.ctx).make_global_state()
    by_name, window = device_activity(
        torch, lambda: app.run_blocks(st, blocks))
    busy_us = sum(us for _, us in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    dm_names = tuple(f"void (anonymous namespace)::{k}<"
                     for k in ("scatter_walk_sm90_kernel", *(
                         k for op in DM_KERNELS.values()
                         for k in op.values())))
    dm = [(c, us) for name, (c, us) in by_name.items()
          if name.startswith(dm_names)]
    say("profile", iters=iters, aten_ops_per_iter=ops_per_iter,
        window_ms_per_iter=f"{window * 1e3 / iters:.4f}",
        device_busy_ms_per_iter=f"{busy_us / 1e3 / iters:.5f}",
        idle_share=f"{1 - busy_us / 1e6 / window:.4f}",
        device_activities_per_iter=sum(c for c, _ in by_name.values())
        / iters,
        datamover_ms_per_iter=f"{sum(us for _, us in dm) / 1e3 / iters:.5f}",
        datamover_launches_per_iter=sum(c for c, _ in dm) / iters,
        datamover_share_of_busy=f"{sum(us for _, us in dm) / busy_us:.4f}")
    for name, (count, us) in top:
        say("profile", device_ms_per_iter=f"{us / 1e3 / iters:.5f}",
            per_iter=count / iters, name=name[:70].replace(" ", "_"))
    return ops_per_iter


# ---------------------------------------------------------------------------
# phase 7: the rest of Shoal's message layer (vectored puts, the reliable
# put over lossy links, mailboxes) on 8 kernels
# ---------------------------------------------------------------------------

MSG_SEG_WORDS = 65536      # each kernel's segment in the message phase
REL_SEGS = 16              # reliable put: 16 x 2250 words (144 KB) a kernel
VEC_BLOCKS, VEC_WORDS = 34, 64   # 2176 payload + 34 address words
MBOX_SENDS, MBOX_WORDS = 1024, 4     # bench_comm.py's mailbox flush
# the reliable put's fault settings (max_retries 4): drop 0 % keeps the
# reliable path with a drop that never fires, as bench_faults.py does
REL_FAULTS = {"drop-0pct": dict(drop=1e-12), "drop-1pct": dict(drop=0.01),
              "drop-5pct": dict(drop=0.05), "dup-5pct": dict(dup=0.05),
              "corrupt-2pct": dict(corrupt=0.02)}


def _same_state(torch, a, b, what):
    """Every PgasState field of a card run bitwise equal to the CPU
    run's."""
    import dataclasses as dc

    for f in dc.fields(a):
        x, y = getattr(a, f.name).cpu(), getattr(b, f.name)
        if x.is_floating_point():
            x, y = _bits(torch, x), _bits(torch, y)
        require(torch.equal(x, y), f"{what}: {f.name} differs between the "
                f"card and the CPU ({int((x != y).sum())} words)")


def _on_both(torch, device, prog, what):
    """Run ``prog(device) -> (ctx, state)`` on the card, then on the CPU;
    require the two states bitwise equal and the same exchange count.
    Returns the card's ``(ctx, state)``, the DataMover launches of the
    card run by counter and its host ms."""
    from repro_torch.kernels import launch_counts

    before = launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ctx, st = prog(device)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    launched = {k: v - before[k] for k, v in launch_counts().items()
                if v != before[k]}
    ctx_c, st_c = prog(torch.device("cpu"))
    _same_state(torch, st, st_c, what)
    require(ctx.exchanges == ctx_c.exchanges,
            f"{what}: {ctx.exchanges} exchanges on the card, "
            f"{ctx_c.exchanges} on the CPU")
    require(any(k.startswith("datamover") for k in launched),
            f"{what}: no DataMover launch on the card ({launched})")
    return ctx, st, launched, host_ms


def _vectored_prog(torch, pay, dtype, asynchronous):
    from repro_torch.core import ops
    from repro_torch.core.state import ShoalContext, replace
    from repro_torch.runtime import TCP

    def prog(dev):
        ctx = ShoalContext(K, dataclasses.replace(
            TCP, max_packet_bytes=4 * MTU_WORDS), MSG_SEG_WORDS, device=dev)
        st = ctx.make_state()
        st = replace(st, segment=st.segment.to(dtype))
        p = torch.from_numpy(pay).to(device=dev, dtype=dtype)
        blocks = [p[:, i * VEC_WORDS:(i + 1) * VEC_WORDS]
                  for i in range(VEC_BLOCKS)]
        addrs = [100 + 67 * i for i in range(VEC_BLOCKS)]
        st = ops.put_long_vectored(ctx, st, blocks, RING, addrs, token=1,
                                   asynchronous=asynchronous)
        if not asynchronous:
            st = ops.wait_replies(ctx, st, 1, 1)
        return ctx, st
    return prog


def _reliable_prog(torch, pay, faults, mtu_words, seg_words, seed):
    from repro_torch.core import ops
    from repro_torch.core.faults import FaultModel
    from repro_torch.core.state import ShoalContext
    from repro_torch.runtime import LossyTransport

    def prog(dev):
        t = LossyTransport(faults=FaultModel(seed=seed, **faults),
                           max_packet_bytes=4 * mtu_words, max_retries=4)
        ctx = ShoalContext(K, t, seg_words, device=dev)
        st = ops.put_long(ctx, ctx.make_state(),
                          torch.from_numpy(pay).to(dev), RING, dst_addr=10,
                          token=1)
        return ctx, ops.wait_replies(ctx, st, 1, 1, timeout=True)
    return prog


def _mailbox_progs(torch, pay):
    from repro_torch.actors import MultiMailbox
    from repro_torch.core import ops
    from repro_torch.core.state import ShoalContext
    from repro_torch.runtime import TCP

    even = [(i, i + 1) for i in range(0, K, 2)]
    odd = [(i, (i + 1) % K) for i in range(1, K, 2)]

    def ctx_on(dev):
        return ShoalContext(K, dataclasses.replace(
            TCP, max_packet_bytes=4 * MTU_WORDS), MSG_SEG_WORDS, device=dev)

    def flush_1024(dev):
        ctx = ctx_on(dev)
        st = ctx.make_state()
        mb = ctx.mailbox(RING, msg_words=MBOX_WORDS, watermark=1 << 20,
                         token=5)
        base = np.arange(MBOX_WORDS, dtype=np.float32)
        for i in range(MBOX_SENDS):
            st = mb.send(st, base + i, dst_addr=MBOX_WORDS * i)
        st = mb.flush(st)
        return ctx, ops.wait_replies(ctx, st, 5, 1)

    def grouped(dev):
        ctx = ctx_on(dev)
        st = ctx.make_state()
        p = torch.from_numpy(pay[:, :512]).to(dev)
        mmb = MultiMailbox(ctx, [even, odd], msg_words=MBOX_WORDS,
                           watermark=1 << 20, token=6)
        for i in range(64):
            st = mmb.send(st, 0, p[:, 4 * i:4 * i + 4], dst_addr=4 * i)
            st = mmb.send(st, 1, p[:, 256 + 4 * i:260 + 4 * i],
                          dst_addr=1024 + 4 * i)
        st = mmb.flush(st)
        return ctx, ops.wait_replies(ctx, st, 6, 1)

    def replies(dev):
        ctx = ctx_on(dev)
        st = ctx.make_state()
        rmb = ctx.reply_mailbox()
        p = torch.from_numpy(pay[:, :MTU_WORDS]).to(dev)
        for i in range(4):
            st = ops.put_long(ctx, st, p, RING, dst_addr=MTU_WORDS * i,
                              token=2, reply_via=rmb)
        st = rmb.flush(st)
        return ctx, ops.wait_replies(ctx, st, 2, 4)

    return {"mailbox-1024x4": (flush_1024, 2),
            "multi-mailbox-2x64": (grouped, 2),
            "reply-mailbox-4puts": (replies, 5)}


def _pred_rows(a):
    return a[[(k - 1) % K for k in range(K)]]


def phase_messages(torch, device):
    """Vectored puts (34 x 64 words, f32 and bf16, acked and async), the
    reliable put (16 x 2250 words a kernel over a lossy ring at 0 / 1 /
    5 % drop, 5 % duplicates and 2 % corruption; bench_faults.py's
    16-word put at 0 / 1 / 5 %) and the mailboxes (1024 four-word sends
    in one flush, a grouped MultiMailbox flush, a ReplyMailbox
    coalescing a 4-put phase), each on the card and on the CPU, bitwise
    equal, at the reference's exchange counts.  Returns the launch
    counts after the phase (the caller zeroes them before it)."""
    from repro_torch.core import ops
    from repro_torch.core.state import ERR_RETRY_EXHAUSTED
    from repro_torch.kernels import launch_counts

    rng = np.random.default_rng(17)

    # -- vectored puts -------------------------------------------------------
    pay = rng.standard_normal((K, VEC_BLOCKS * VEC_WORDS)).astype(np.float32)
    want_exch = {("float32", False): 2, ("float32", True): 1,
                 ("bfloat16", False): 4, ("bfloat16", True): 3}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for asynchronous in (False, True):
            what = f"vectored-{name}-{'async' if asynchronous else 'acked'}"
            ctx, st, launched, ms = _on_both(
                torch, device, _vectored_prog(torch, pay, dtype,
                                              asynchronous), what)
            n = want_exch[name, asynchronous]
            require(ctx.exchanges == n,
                    f"{what}: {ctx.exchanges} exchanges, expected {n}")
            seg = st.segment.float().cpu().numpy()
            src = _pred_rows(torch.from_numpy(pay).to(dtype).float().numpy())
            for i in range(VEC_BLOCKS):
                a = 100 + 67 * i
                require(np.array_equal(
                    seg[:, a:a + VEC_WORDS],
                    src[:, i * VEC_WORDS:(i + 1) * VEC_WORDS]),
                    f"{what}: block {i} did not land")
            require(bool((st.credits == 0).all()), f"{what}: credits")
            say("messages", run=what, exchanges=ctx.exchanges,
                host_ms=f"{ms:.3f}", datamover_launches=json.dumps(launched),
                bitwise_cpu="equal")
    from repro_torch.core.state import ShoalContext
    ctx = ShoalContext(K, segment_words=MSG_SEG_WORDS, device=device)
    try:
        ops.put_long_vectored(ctx, ctx.make_state(),
                              [torch.ones(K, 8, device=device)] * 2, RING,
                              [64, 68])
        raise AssertionError("an aliasing address list was not refused")
    except ops.VectoredAliasError:
        say("messages", run="vectored-alias", refused="VectoredAliasError")

    # -- the reliable put ---------------------------------------------------
    rel = rng.standard_normal((K, REL_SEGS * MTU_WORDS)).astype(np.float32)
    for name, faults in REL_FAULTS.items():
        what = f"reliable-{name}"
        ctx, st, launched, ms = _on_both(
            torch, device, _reliable_prog(torch, rel, faults, MTU_WORDS,
                                          MSG_SEG_WORDS, seed=7), what)
        require(ctx.exchanges == 10, f"{what}: {ctx.exchanges} exchanges")
        require(bool((st.dedup_seen == 0).all()), f"{what}: ledger residue")
        require(not bool((st.error & ERR_RETRY_EXHAUSTED).any()),
                f"{what}: retries exhausted")
        require(np.array_equal(
            st.segment[:, 10:10 + rel.shape[1]].cpu().numpy(),
            _pred_rows(rel)), f"{what}: delivery not bit-identical")
        say("messages", run=what, exchanges=ctx.exchanges,
            host_ms=f"{ms:.3f}", tx_words=int(st.tx_words.sum()),
            retransmits=json.dumps(st.retransmits.tolist()),
            error=json.dumps(st.error.tolist()), ledger="drained",
            datamover_launches=json.dumps(launched), bitwise_cpu="equal")
    bench = ((np.arange(16, dtype=np.float32) + 1)[None]
             * (np.arange(K, dtype=np.float32) + 1)[:, None])
    for pct, drop in (("0", 1e-12), ("1", 0.01), ("5", 0.05)):
        what = f"reliable-bench_faults-{pct}pct"
        ctx, st, launched, ms = _on_both(
            torch, device, _reliable_prog(torch, bench, dict(drop=drop), 4,
                                          64, seed=7), what)
        require(bool((st.dedup_seen == 0).all())
                and not bool((st.error & ERR_RETRY_EXHAUSTED).any())
                and np.array_equal(st.segment[:, 10:26].cpu().numpy(),
                                   _pred_rows(bench)), f"{what}: delivery")
        say("messages", run=what, exchanges=ctx.exchanges,
            host_ms=f"{ms:.3f}", tx_words=int(st.tx_words.sum()),
            mean_retransmits=float(st.retransmits.float().mean()),
            datamover_launches=json.dumps(launched), bitwise_cpu="equal")

    # -- mailboxes -----------------------------------------------------------
    mpay = rng.standard_normal((K, 4096)).astype(np.float32)
    for what, (prog, n) in _mailbox_progs(torch, mpay).items():
        ctx, st, launched, ms = _on_both(torch, device, prog, what)
        require(ctx.exchanges == n,
                f"{what}: {ctx.exchanges} exchanges, expected {n}")
        require(bool((st.credits == 0).all())
                and bool((st.error == 0).all()), f"{what}: credits/error")
        say("messages", run=what, exchanges=ctx.exchanges,
            host_ms=f"{ms:.3f}", datamover_launches=json.dumps(launched),
            bitwise_cpu="equal")
    seg = st.segment.cpu().numpy()          # the 4-put reply phase
    require(all(np.array_equal(seg[:, MTU_WORDS * i:MTU_WORDS * (i + 1)],
                               _pred_rows(mpay[:, :MTU_WORDS]))
                for i in range(4)), "reply-mailbox puts did not land")
    counts = launch_counts()
    count_message_ops(torch, device, rel)
    return counts


def count_message_ops(torch, device, rel):
    """Aten operations dispatched by the credit-file updates of the
    1024-send flush (scatter-adds, and the row-by-row walk they
    replace) and by one whole reliable 16 x 2250 put at 1 % drop."""
    from repro_torch.core import gascore as gc
    from repro_torch.core import ops
    from repro_torch.core.state import ShoalContext

    ctx = ShoalContext(K, segment_words=MSG_SEG_WORDS, device=device)
    mb = ctx.mailbox(RING, msg_words=MBOX_WORDS, watermark=1 << 20, token=5)
    st = ctx.make_state()
    for i in range(MBOX_SENDS):
        st = mb.send(st, np.arange(MBOX_WORDS, dtype=np.float32) + i,
                     dst_addr=MBOX_WORDS * i)
    hdrs, pays, _ = mb._stack()
    hdr_r, _ = ops._exchange(ctx, RING, hdrs, pays)
    counted = {}
    for name, fn in (("flush_credit_rows", gc._credit_rows),
                     ("flush_credit_walk", gc._credit_walk)):
        mode = count_ops_mode()()
        with mode:
            fn(ctx, st, hdr_r)
        counted[name] = mode.count
    prog = _reliable_prog(torch, rel, dict(drop=0.01), MTU_WORDS,
                          MSG_SEG_WORDS, seed=7)
    mode = count_ops_mode()()
    with mode:
        prog(device)
    counted["reliable_put_16x2250"] = mode.count
    say("messages", aten_ops=json.dumps(counted))


def check_message_shapes(torch, device):
    """Both DataMover designs at the message layer's shapes, bitwise
    against the plain version and timed one turn each (the sweep takes
    both orders): the 1024-send mailbox flush, the vectored put's egress
    row and its 34 blocks (uniform and ragged, f32 and bf16), the
    reliable put's egress and its stack of 32 rows with gated
    duplicates, and bench_faults' 4 x 4 put.  Returns each shape's
    measurements by (op, case)."""
    from repro_torch.kernels import am_pack as dm

    gen = torch.Generator(device="cpu").manual_seed(5)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen).to(device=device,
                                                     dtype=dtype)

    def i32(rows):
        return torch.tensor(rows, dtype=torch.int32, device=device)

    out = {}
    kw = dict(floor=floor_ms(torch, device), order=("sm90", "simple"))
    ones = [[1] * MBOX_SENDS] * K
    out["scatter", "mailbox-1024x4"] = check_scatter(
        torch, dm, randn(K, MSG_SEG_WORDS), randn(K, MBOX_SENDS, MBOX_WORDS),
        i32([[MBOX_WORDS * b for b in range(MBOX_SENDS)]] * K),
        i32([[MBOX_WORDS] * MBOX_SENDS] * K), i32(ones), i32(ones),
        "mailbox-1024x4", plain_reps=1, **kw)
    vec_addr = i32([[100 + 67 * b for b in range(VEC_BLOCKS)]] * K)
    ragged = [VEC_WORDS - (7 * b) % 32 for b in range(VEC_BLOCKS)]
    offs = np.cumsum([0] + ragged[:-1]).tolist()
    vb = [[1] * VEC_BLOCKS] * K
    for dtype in (torch.float32, torch.bfloat16):
        tag = "" if dtype == torch.float32 else "-bf16"
        n = VEC_BLOCKS * VEC_WORDS
        out["gather", "vectored-egress" + tag] = check_gather(
            torch, dm, randn(K, n, dtype=dtype), i32([[0]] * K),
            i32([[n]] * K), n, "vectored-egress-1x2176" + tag, **kw)
        out["scatter", "vectored-34x64" + tag] = check_scatter(
            torch, dm, randn(K, MSG_SEG_WORDS, dtype=dtype),
            randn(K, VEC_BLOCKS, VEC_WORDS, dtype=dtype), vec_addr,
            i32([[VEC_WORDS] * VEC_BLOCKS] * K), i32(vb), i32(vb),
            "vectored-34x64" + tag, **kw)
        out["gather", "vectored-ragged" + tag] = check_gather(
            torch, dm, randn(K, sum(ragged), dtype=dtype), i32([offs] * K),
            i32([ragged] * K), VEC_WORDS, "vectored-ragged-34x64" + tag,
            **kw)
        out["scatter", "vectored-ragged" + tag] = check_scatter(
            torch, dm, randn(K, MSG_SEG_WORDS, dtype=dtype),
            randn(K, VEC_BLOCKS, VEC_WORDS, dtype=dtype), vec_addr,
            i32([ragged] * K), i32(vb), i32(vb),
            "vectored-ragged-34x64" + tag, **kw)
    # the reliable put: egress of 16 segments, then a stack of the 16
    # rows and their duplicates, the dedup verdict as the active mask
    rel_addr = [10 + MTU_WORDS * s for s in range(REL_SEGS)]
    out["gather", "reliable-egress"] = check_gather(
        torch, dm, randn(K, REL_SEGS * MTU_WORDS),
        i32([[MTU_WORDS * s for s in range(REL_SEGS)]] * K),
        i32([[MTU_WORDS] * REL_SEGS] * K), MTU_WORDS,
        "reliable-egress-16x2250", **kw)
    gate = [[int(s % 5 != 3) for s in range(REL_SEGS)]
            + [int(s % 7 == 0) for s in range(REL_SEGS)] for _ in range(K)]
    rows = randn(K, REL_SEGS, MTU_WORDS)
    out["scatter", "reliable-stack"] = check_scatter(
        torch, dm, randn(K, MSG_SEG_WORDS),
        torch.cat([rows, rows], dim=1).contiguous(),
        i32([rel_addr * 2] * K), i32([[MTU_WORDS] * 2 * REL_SEGS] * K),
        i32([[1] * 2 * REL_SEGS] * K), i32(gate),
        "reliable-stack-32x2250-gated-dup", **kw)
    out["gather", "bench_faults-egress"] = check_gather(
        torch, dm, randn(K, 16), i32([[0, 4, 8, 12]] * K),
        i32([[4] * 4] * K), 4, "bench_faults-egress-4x4", **kw)
    small = randn(K, 4, 4)
    out["scatter", "bench_faults-stack"] = check_scatter(
        torch, dm, randn(K, 64), torch.cat([small, small], 1).contiguous(),
        i32([[10, 14, 18, 22] * 2] * K), i32([[4] * 8] * K),
        i32([[1] * 8] * K), i32([[1, 1, 1, 1, 0, 1, 0, 0]] * K),
        "bench_faults-stack-8x4-gated-dup", **kw)
    for (op, case), m in out.items():
        faster = min(m["design_ms"], key=m["design_ms"].get)
        say("kernels", kernel=f"datamover_{op}", case=case,
            route=m["route"], faster_in_this_call=faster,
            route_is_faster=faster == m["route"])
    return out


# ---------------------------------------------------------------------------
# phase 5: the ring collectives, the RDMA ring and HUMboldt on 8 kernels
# ---------------------------------------------------------------------------

def ring_buffer(torch, x, n):
    """``x (K, ...)`` as the ring collectives hand it to the kernel: every
    kernel's flat value zero-padded to ``(K, n, ceil(size / n))``."""
    from repro_torch.core.collectives import _pad_to_chunks

    return _pad_to_chunks(x, n)[0]


def host_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Host-clock ms per call of ``fn`` over ``reps`` calls that end in a
    device synchronisation (on a CUDA device)."""
    def sync():
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    for _ in range(warmup):
        fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync()
    return (time.perf_counter() - t0) * 1e3 / reps


def _ring_main_path(torch, coll, gd, ctx, data):
    """The path's entry points as a user calls them: the data-parallel
    trainer's ``shoal`` backend (``ring_all_reduce`` of a gradient leaf
    in float32 and, compressed, in int32 with its size-1 scale, and of
    tinyllama-1.1b's 2048-word RMSNorm gain), the ring reduce-scatter /
    all-gather, broadcast, all-to-all and barrier, and the GAScore's RDMA
    ring all-reduce.  Each call is checked for its exchange count;
    returns the outputs by name and each call's launches by counter."""
    from repro_torch.kernels import launch_counts

    calls = [
        ("ar_f32", 2 * (K - 1),
         lambda: coll.ring_all_reduce(ctx, data["leaf"])),
        ("ar_i32", 2 * (K - 1),
         lambda: coll.ring_all_reduce(ctx, data["leaf_i32"])),
        ("ar_scale", 2 * (K - 1),
         lambda: coll.ring_all_reduce(ctx, data["scale"])),
        ("ar_norm", 2 * (K - 1),
         lambda: coll.ring_all_reduce(ctx, data["norm"])),
        ("rs", K - 1, lambda: coll.ring_reduce_scatter(ctx, data["mb"])),
        ("ag", K - 1, lambda: coll.ring_all_gather(ctx, out["rs"])),
        ("bc", 2 * (K - 1),
         lambda: coll.broadcast_from(ctx, data["bc"], root=5)),
        ("a2a", 1, lambda: coll.all_to_all_vectored(ctx, data["mb"])),
        ("barrier", 0, lambda: coll.tree_barrier(ctx)),
        ("dma_f32", 0, lambda: gd.ring_allreduce_dma(data["leaf"])),
        ("dma_bf16", 0, lambda: gd.ring_allreduce_dma(data["leaf_bf16"])),
    ]
    out, launches = {}, {}
    for name, n_ex, fn in calls:
        before, counts = ctx.exchanges, launch_counts()
        out[name] = fn()
        require(ctx.exchanges - before == n_ex,
                f"{name}: {ctx.exchanges - before} exchanges, expected {n_ex}")
        launches[name] = {k: v - counts[k] for k, v in launch_counts().items()
                          if v != counts[k]}
    return out, launches


def _check_sums(torch, data, out):
    """Every result against its closed form: float64 sums within the
    reference's tolerances relative to the largest |sum| (float32 1e-5,
    bfloat16 5e-2), int32 exactly, copies and barriers bitwise."""
    def close(got, want, tol, what):
        err = (got.double() - want).abs().max().item()
        limit = tol * want.abs().max().item()
        require(err <= limit, f"{what}: max|err| {err} > {limit}")
        return err

    leaf, mb = data["leaf"], data["mb"]
    c = mb.shape[1] // K
    sum64 = leaf.sum(0, dtype=torch.float64)
    ar = out["ar_f32"]
    require(torch.equal(ar, ar[:1].expand_as(ar)), "ar_f32: rows differ")
    errs = dict(
        ar_f32=close(ar[:1], sum64, 1e-5, "ar_f32"),
        dma_f32=close(out["dma_f32"], sum64, 1e-5, "dma_f32"),
        dma_bf16=close(out["dma_bf16"], data["leaf_bf16"].sum(
            0, dtype=torch.float64), 5e-2, "dma_bf16"),
        ar_scale=close(out["ar_scale"], data["scale"].sum(
            0, dtype=torch.float64), 1e-5, "ar_scale"),
        ar_norm=close(out["ar_norm"], data["norm"].sum(
            0, dtype=torch.float64), 1e-5, "ar_norm"),
        rs=close(out["rs"], mb.reshape(K, K, c).sum(0, dtype=torch.float64),
                 1e-5, "rs"))
    i32 = out["ar_i32"]
    require(torch.equal(i32, data["leaf_i32"].sum(0, dtype=torch.int32)
                        .expand_as(i32)), "ar_i32 differs from the sum")
    require(torch.equal(out["ag"], out["rs"][None].expand(K, K, c)),
            "ag: rows are not the chunks in kernel order")
    require(torch.equal(out["bc"], data["bc"][5].expand_as(out["bc"])),
            "bc: not the root's payload everywhere")
    for k in range(K):
        for i in range(K):
            require(torch.equal(out["a2a"][k, i * c:(i + 1) * c],
                                mb[i, k * c:(k + 1) * c]), "a2a blocks")
    require(out["barrier"].tolist() == [K] * K, "tree_barrier")
    return errs


RING_TURNS = ("sm90", "simple", "library", "library", "simple", "sm90")
# the main-path calls ring_kernel_for sends to the cluster kernel
RING_SM90_CALLS = ("rs", "ag", "ar_norm")


def _ring_cases(torch, gd, data, out):
    """``(call, case, wrapper, schedule, kernel input, main-path output
    shaped as the kernel's, library call, bytes, adds)`` for every
    phase-5 ring case."""
    leaf, mb = data["leaf"], data["mb"]
    leaf_words, mb_words = leaf.shape[1], mb.shape[1]
    c_mb = mb_words // K
    ops_leaf = (K - 1) * leaf_words               # K-1 adds per word

    def allreduce(x):
        return lambda: x.sum(0, keepdim=True).expand_as(x).contiguous()

    cases = []
    for call, case, key in (("dma_f32", "dma-leaf-f32", "leaf"),
                            ("dma_bf16", "dma-leaf-bf16", "leaf_bf16")):
        x = data[key]
        cases.append((call, case, "ring_allreduce_dma", gd.DMA, x,
                      out[call], allreduce(x), 2 * x.nbytes, ops_leaf))
    for call, case, key in (("ar_f32", "all_reduce-leaf-f32", "leaf"),
                            ("ar_i32", "all_reduce-leaf-int32", "leaf_i32"),
                            ("ar_norm", "all_reduce-norm-2048", "norm"),
                            ("ar_scale", "all_reduce-scale-1", "scale")):
        x = data[key]
        buf = ring_buffer(torch, x, K)
        cases.append((call, case, "ring_collective", gd.ALL_REDUCE, buf,
                      ring_buffer(torch, out[call], K), allreduce(x),
                      2 * buf.nbytes, (K - 1) * buf[0].numel()))
    buf_mb = mb.reshape(K, K, c_mb)
    rs = out["rs"]
    cases += [
        ("rs", "reduce_scatter-1MB", "ring_collective", gd.REDUCE_SCATTER,
         buf_mb, rs, lambda: buf_mb.sum(0), mb.nbytes + mb.nbytes // K,
         (K - 1) * mb_words),
        ("ag", "all_gather-1MB", "ring_collective", gd.ALL_GATHER, rs,
         out["ag"], lambda: rs[None].expand(K, K, c_mb).contiguous(),
         mb.nbytes + mb.nbytes // K, 0),
    ]
    return cases


def _ring_fns(gd, wrapper, schedule, x):
    """The cluster kernel forced, the simple kernel forced, and the plain
    version, on ``x``."""
    if wrapper == "ring_allreduce_dma":
        return (lambda: gd.ring_allreduce_dma_cuda(x, kernel="sm90"),
                lambda: gd.ring_allreduce_dma_cuda(x, kernel="simple"),
                lambda: gd.ring_allreduce_dma_ref(x))
    return (lambda: gd.ring_collective_cuda(x, schedule, kernel="sm90"),
            lambda: gd.ring_collective_cuda(x, schedule, kernel="simple"),
            lambda: gd.ring_collective_ref(x, schedule))


def phase_collectives(torch, device, leaf_words=LEAF_WORDS,
                      mb_words=MB_WORDS):
    """Phase 5.  The main path (counts reset before it, read after it),
    every result against its closed form, each ring call's kernel against
    ``ring_kernel_for``'s route by the launch counters (the 1 MB
    reduce-scatter / all-gather and the norm leaf through the cluster
    kernel); then at every ring case both ring kernels against the plain
    version on the same inputs, bitwise, with device times of the
    cluster kernel, the simple kernel and the library call in turns;
    then HUMboldt against closed forms, timed beside an acked put.
    Returns one record per ring case."""
    from repro_torch.core import collectives as coll
    from repro_torch.core.state import ShoalContext
    from repro_torch.kernels import (gascore_dma as gd, launch_counts,
                                     reset_launch_counts)

    gen = torch.Generator(device=device).manual_seed(12)
    data = dict(leaf=torch.randn(K, leaf_words, generator=gen, device=device),
                leaf_i32=torch.randint(-127, 128, (K, leaf_words),
                                       generator=gen, device=device,
                                       dtype=torch.int32),
                scale=torch.rand(K, 1, generator=gen, device=device),
                mb=torch.randn(K, mb_words, generator=gen, device=device),
                norm=torch.randn(K, NORM_WORDS, generator=gen,
                                 device=device))
    data["leaf_bf16"] = data["leaf"].to(torch.bfloat16)
    data["bc"] = data["mb"].clone()
    data["bc"][:, ::3] = 0.0                  # payloads may hold zeros
    ctx = ShoalContext(K, device=device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    reset_launch_counts()
    out, per_call = _ring_main_path(torch, coll, gd, ctx, data)
    if cuda:
        torch.cuda.synchronize()
    counts = launch_counts()
    if cuda:
        require(counts["ring_allreduce_dma"] >= 2
                and counts["ring_collective"] >= 6,
                f"ring kernels not launched on the main path: {counts}")
    routes = {}
    for (call, case, wrapper, schedule, x, *_rest) in _ring_cases(
            torch, gd, data, out):
        routes[call] = gd.ring_kernel_for(K, x.shape[-1], x.dtype, schedule)
        if cuda:
            require(per_call[call].get(wrapper) == 1
                    and per_call[call].get("ring_cluster_sm90", 0)
                    == (routes[call] == "sm90"),
                    f"{call} ({case}): launches {per_call[call]}, route "
                    f"{routes[call]}")
    require(all(routes[c] == "sm90" for c in RING_SM90_CALLS),
            f"routes {routes}: {RING_SM90_CALLS} must take the cluster "
            "kernel")
    errs = _check_sums(torch, data, out)
    say("collectives", main_path="ok", exchanges=ctx.exchanges,
        launches=counts, **{f"sum_err_{k}": v for k, v in errs.items()})
    say("collectives", routes=json.dumps(routes),
        launches_per_call=json.dumps(per_call))
    if cuda:      # host clock per all-reduce call, synchronised
        ms = host_ms(torch, lambda: coll.ring_all_reduce(ctx, data["leaf"]),
                     reps=10)
        say("collectives", case="all_reduce-tinyllama-embedding-f32",
            call_host_ms=f"{ms:.4f}")

    records = []
    for (call, case, wrapper, schedule, x, main_out, lib, nbytes,
         ops) in _ring_cases(torch, gd, data, out):
        sm90, simple, plain = _ring_fns(gd, wrapper, schedule, x)
        if not cuda:                  # a CPU rehearsal has no kernels
            sm90 = simple = plain
        got, want = sm90(), plain()
        forced = simple()
        if cuda:
            torch.cuda.synchronize()
        require(torch.equal(got, want) and torch.equal(forced, want)
                and torch.equal(main_out, want),
                f"{wrapper} {case}: cluster kernel, simple kernel, main "
                "path and plain version differ")
        err = (got.double() - want.double()).abs().max().item()
        del got, want, forced
        K_, c = x.shape[0], x.shape[-1]
        plan = gd.cluster_tile_plan(K_, c, x.dtype, schedule)
        m = dict(err=err, nbytes=nbytes, ops=ops, ms=None, plain=None,
                 lib=None)
        turns = {"sm90": [], "simple": [], "library": []}
        clusters = None
        if cuda:
            fns = {"sm90": sm90, "simple": simple, "library": lib}
            subs = {"sm90": "ring_cluster_kernel_sm90",
                    "simple": "ring_kernel", "library": None}
            for r in RING_TURNS:
                turns[r].append(device_ms(fns[r], kernel=subs[r]))
            m.update(plain=device_ms(plain, reps=5),
                     lib=float(np.mean(turns["library"])))
            clusters = gd.cluster_max_active(K_, c, x.dtype, schedule)
        mean = {r: float(np.mean(v)) if v else None for r, v in turns.items()}
        # one record per case, named by the kernel the main path ran;
        # launches are that call's, path_launches the whole path's
        ran = per_call[call]
        if routes[call] == "sm90":
            rec = entry("ring_cluster_sm90", RING_SM90_SRC, RING_TPU,
                        dict(m, ms=mean["sm90"]))
            rec.update(launches=ran.get("ring_cluster_sm90", 0),
                       path_launches={
                           "collectives": counts["ring_cluster_sm90"]})
        else:
            rec = entry(wrapper, RING_SRC, RING_TPU,
                        dict(m, ms=mean["simple"]))
            rec.update(launches=ran.get(wrapper, 0)
                       - ran.get("ring_cluster_sm90", 0),
                       path_launches={"collectives": counts[wrapper]})
        rec.update(case=case, main_path_route=routes[call],
                   sm90_ms=mean["sm90"], simple_ms=mean["simple"],
                   turns_ms=turns, plan=plan._asdict(),
                   max_active_clusters=clusters)
        records.append(rec)
        fmt = (lambda v: f"{v:.6f}" if v is not None else None)
        say("collectives", kernel=rec["name"], case=case,
            shape=tuple(x.shape), schedule=schedule, route=routes[call],
            bitwise="equal",
            max_abs_err=err, plan=tuple(plan), max_active_clusters=clusters,
            sm90_ms=fmt(mean["sm90"]), simple_ms=fmt(mean["simple"]),
            library_ms=fmt(m["lib"]), plain_ms=fmt(m["plain"]),
            bound_ms=f"{rec['bound_ms']:.6f}", bound_by=rec["bound_by"],
            turns_ms={r: [fmt(t) for t in v] for r, v in turns.items()})
    phase_humboldt(torch, device)
    return records


def phase_humboldt(torch, device, reps=20):
    """HUMboldt ``sendrecv`` on the 8-kernel ring over TCP at
    bench_latency.py's sizes and a 4-segment message (64-byte frames):
    received data, credits and exchanges (4 per segment) against closed
    forms, and host ms per call beside an acked ``put_long`` +
    ``wait_replies`` of the same size (2 exchanges) -- the paper's
    one-sided vs two-sided comparison."""
    from repro_torch.core import humboldt, ops
    from repro_torch.core.state import ShoalContext
    from repro_torch.runtime import TCP

    pred = [(k - 1) % K for k in range(K)]
    cases = [(nb, TCP) for nb in HUM_BYTES]
    cases.append((256, dataclasses.replace(TCP, max_packet_bytes=64)))
    for nbytes, transport in cases:
        words = nbytes // 4
        segments = -(-words // transport.max_packet_words)
        ctx = ShoalContext(K, transport, 4096, device=device)
        pay = ((torch.arange(K, device=device, dtype=torch.float32)[:, None]
                + 1) * (torch.arange(words, device=device) + 1))
        st = ctx.make_state()
        before = ctx.exchanges
        st, recv = humboldt.sendrecv(ctx, st, pay, RING, token=4)
        require(ctx.exchanges - before == humboldt.HOPS_PER_MESSAGE * segments,
                f"humboldt {nbytes}B: {ctx.exchanges - before} exchanges")
        require(torch.equal(recv, pay[pred]), f"humboldt {nbytes}B: data")
        require(st.credits[:, 4].tolist() == [segments] * K,
                f"humboldt {nbytes}B: credits {st.credits[:, 4].tolist()}")
        st = ops.wait_replies(ctx, st, 4, segments)
        before = ctx.exchanges
        st = ops.put_long(ctx, st, pay, RING, dst_addr=0, token=5)
        st = ops.wait_replies(ctx, st, 5, 1)
        require(ctx.exchanges - before == 2, "acked put: 2 exchanges")
        require(torch.equal(st.segment[:, :words], pay[pred]), "put data")
        require(bool((st.credits == 0).all()) and bool((st.error == 0).all()),
                f"humboldt {nbytes}B: credits/error not zero")
        state = {"st": ctx.make_state()}

        def two_sided():
            s, _ = humboldt.sendrecv(ctx, state["st"], pay, RING, token=4)
            state["st"] = ops.wait_replies(ctx, s, 4, segments)

        def one_sided():
            s = ops.put_long(ctx, state["st"], pay, RING, dst_addr=0, token=5)
            state["st"] = ops.wait_replies(ctx, s, 5, 1)

        say("humboldt", bytes=nbytes, segments=segments,
            mtu_bytes=transport.max_packet_bytes,
            exchanges_two_sided=humboldt.HOPS_PER_MESSAGE * segments,
            exchanges_one_sided=2,
            two_sided_host_ms=f"{host_ms(torch, two_sided, reps):.4f}",
            one_sided_host_ms=f"{host_ms(torch, one_sided, reps):.4f}")


# ---------------------------------------------------------------------------
# phase 6: tinyllama-1.1b served through ServeEngine, the flash kernel
# ---------------------------------------------------------------------------

def serve_prompts(vocab: int, seed: int = 13) -> list[np.ndarray]:
    """``REQUESTS`` prompts of 128-1024 tokens from the seed: the first
    exactly 1024, the second not a multiple of 128."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(PROMPT_MIN, PROMPT_MAX + 1, REQUESTS)
    lens[0] = PROMPT_MAX
    if lens[1] % 128 == 0:
        lens[1] += 1 if lens[1] < PROMPT_MAX else -1
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


def _flash_inputs(torch, gen, device, B, S, H, Kv, dh, dtype):
    return [torch.randn(*shape, generator=gen, device=device).to(dtype)
            for shape in ((B, S, H, dh), (B, S, Kv, dh), (B, S, Kv, dh))]


def _flash_err(torch, got, want, tol, what):
    """max |err| of ``got``; raises beyond atol = rtol = ``tol``, or beyond
    ``tol`` times the largest |want|: over many keys without causality
    every output is small (~sqrt(e / T) for unit-normal inputs), and the
    first limit alone would be as wide as the values."""
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    top = want.float().abs().max().item()
    require(bool(torch.isfinite(got).all())
            and (diff - tol * want.float().abs()).max().item() <= tol
            and err <= tol * top,
            f"{what}: max|err| {err} beyond atol=rtol={tol} or {tol} * "
            f"max|want| {top}")
    return err


def _flash_case(torch, fa, q, k, v, tag, *, kernels, causal=True,
                timed=True):
    """Flash kernels (``kernels``: ``"sm90"``, ``"simple"``) against their
    plain version on the same inputs, each within the tolerance of the
    inputs' type (:func:`_flash_err`).  With ``timed``: device ms in turns
    (the kernels, the plain version over 5 calls a turn,
    ``scaled_dot_product_attention`` -- the library yardstick, used
    nowhere in the port -- then the same in reverse), and the bound by
    bytes (q, k, v read once, the output written once) and by operations
    (S^2 (dqk + dv) a head for the causal QK^T and PV, 2 S T (dqk + dv)
    without causality) at the rate of the inputs' type.  Returns
    ``{kernel: m}``: ``err``, and with ``timed`` ``ms``, ``plain``,
    ``lib``, ``nbytes``, ``ops``, ``rate`` and ``turns``."""
    import torch.nn.functional as F

    B, S, H, dqk = q.shape
    T, dv = k.shape[1], v.shape[-1]
    name = str(q.dtype).split(".")[-1]
    want = fa.flash_attention_ref(q, k, v, causal=causal)
    out = {r: {"err": _flash_err(torch, fa.flash_attention_cuda(
        q, k, v, kernel=r, causal=causal), want, FLASH_TOL[name],
        f"{r} flash kernel, {tag} {name}")} for r in kernels}
    if not timed:
        return out
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

    def run(r):
        if r == "plain":
            return device_ms(lambda: fa.flash_attention_ref(
                q, k, v, causal=causal), reps=5)
        if r == "library":
            return device_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True))
        return device_ms(
            lambda: fa.flash_attention_cuda(q, k, v, kernel=r,
                                            causal=causal),
            kernel=("flash_attention_kernel_sm90" if r == "sm90"
                    else "flash_attention_kernel"))

    order = tuple(kernels) + ("plain", "library")
    turns = {r: [] for r in order}
    for r in order + order[::-1]:
        turns[r].append(run(r))
    base = dict(plain=float(np.mean(turns["plain"])),
                lib=float(np.mean(turns["library"])),
                nbytes=(q.numel() + k.numel() + v.numel() + want.numel())
                * q.element_size(),
                ops=B * H * (S * S if causal else 2 * S * T) * (dqk + dv),
                rate=BF16_FLOPS if q.dtype == torch.bfloat16 else F32_FLOPS,
                turns={r: [round(t, 5) for t in ts]
                       for r, ts in turns.items()})
    del qt, kt, vt, want
    return {r: dict(base, err=m["err"], ms=float(np.mean(turns[r])))
            for r, m in out.items()}


def check_flash(torch, device):
    """Both flash kernels against the plain version on the card, on the
    same inputs: the Hopper kernel (``flash_sm90.cu``, which the wrapper
    picks for every bfloat16 input here) and the simple kernel
    (``flash.cu``, forced), at the prefill shapes of the served models
    (B 1, S 1024): tinyllama-1.1b's (H 32, K 4, dh 64), qwen2-1.5b's
    (H 12, K 2, dh 128), deepseek-7b's (H 32, K 32, dh 128: group size
    1), musicgen-medium's (H 24, K 24, dh 64) and dbrx-132b's (H 48, K
    8, dh 128), a ragged S = 1000 and
    a served prompt's S = 903; the simple kernel alone in float32
    (tinyllama's shape and a reference shape at dh 128).  At the
    prefill shapes, timed by :func:`_flash_case`.  Returns the records
    of the simple kernel (bfloat16, tinyllama) and of the Hopper
    kernel."""
    from repro_torch.kernels import attention as fa

    gen = torch.Generator(device=device).manual_seed(21)
    cases = [("tinyllama-prefill", (1, 1024, 32, 4, 64), torch.bfloat16),
             ("tinyllama-prefill", (1, 1024, 32, 4, 64), torch.float32),
             ("qwen2-1.5b-prefill", (1, 1024, 12, 2, 128), torch.bfloat16),
             ("deepseek-7b-prefill", (1, 1024, 32, 32, 128), torch.bfloat16),
             ("musicgen-medium-prefill", (1, 1024, 24, 24, 64),
              torch.bfloat16),
             ("dbrx-132b-prefill", (1, 1024, 48, 8, 128), torch.bfloat16),
             ("ragged-1000", (1, 1000, 32, 4, 64), torch.bfloat16),
             ("served-903", (1, 903, 32, 4, 64), torch.bfloat16),
             ("reference-dh128", (4, 128, 1, 1, 128), torch.float32)]
    records, timed = {}, {}
    for case, (B, S, H, Kv, dh), dtype in cases:
        q, k, v = _flash_inputs(torch, gen, device, B, S, H, Kv, dh, dtype)
        name = str(dtype).split(".")[-1]
        route = fa.flash_kernel_for(q, k, v)
        require(route == ("sm90" if dtype == torch.bfloat16 else "simple"),
                f"flash {case} {name}: dispatched to {route}")
        ms = _flash_case(torch, fa, q, k, v, case,
                         kernels=tuple(dict.fromkeys((route, "simple"))),
                         timed=case.endswith("-prefill"))
        line = dict(case=case, shape=f"B{B}xS{S}xH{H}xK{Kv}xdh{dh}",
                    dtype=name, tol=FLASH_TOL[name],
                    **{f"{r}_max_abs_err": m["err"] for r, m in ms.items()})
        if case.endswith("-prefill"):
            timed.update({(case, name, r): m for r, m in ms.items()})
            m = ms[route]
            bound_ms, bound_by = bound(m)
            line.update({f"{r}_ms": f"{m['ms']:.5f}" for r, m in ms.items()},
                        plain_ms=f"{m['plain']:.5f}",
                        library_ms=f"{m['lib']:.5f}",
                        bound_ms=f"{bound_ms:.5f}", bound_by=bound_by,
                        turns_ms=json.dumps(m["turns"]))
        say("serving", kernel="flash_attention", **line)
        del q, k, v
    tiny = ("tinyllama-prefill", "bfloat16")
    records["flash_attention"] = entry("flash_attention", FLASH_SRC,
                                       FLASH_TPU, timed[(*tiny, "simple")])
    sm90 = entry("flash_attention_sm90", FLASH_SM90_SRC, FLASH_TPU,
                 timed[(*tiny, "sm90")])
    sm90["simple_ms"] = timed[(*tiny, "simple")]["ms"]
    for key, case, shape in (
            ("qwen2_dh128", "qwen2-1.5b-prefill", "B1xS1024xH12xK2xdh128"),
            ("deepseek_7b_dh128", "deepseek-7b-prefill",
             "B1xS1024xH32xK32xdh128"),
            ("musicgen_medium_dh64", "musicgen-medium-prefill",
             "B1xS1024xH24xK24xdh64"),
            ("dbrx_132b_dh128", "dbrx-132b-prefill",
             "B1xS1024xH48xK8xdh128")):
        m = timed[case, "bfloat16", "sm90"]
        sm90[key] = {
            "shape": shape, "ms": m["ms"],
            "simple_ms": timed[case, "bfloat16", "simple"]["ms"],
            "plain_ms": m["plain"], "library_ms": m["lib"],
            "bound_ms": bound(m)[0], "max_abs_err": m["err"]}
    records["flash_attention_sm90"] = sm90
    return records


def attention_layers(cfg) -> int:
    """The layers whose prompt pass launches a flash kernel: every layer
    but the hybrid family's RG-LRU blocks."""
    return sum(reps * sum(kind != "rglru" for kind in pat)
               for pat, reps in cfg.segments())


def prompt_batch(torch, model, prompt):
    """A one-request prefill batch of token ids on the model's device."""
    return {"tokens": torch.as_tensor(prompt.astype(np.int64),
                                      device=model.device)[None]}


def check_prefill_logits(torch, model, params, batch, tag="serving",
                         flash=None):
    """One full-width prefill's last-token logits through the flash
    kernel (fresh lanes) against the same prefill with the kernel's plain
    version in its place (checked), and against the same prefill through
    the plain route ``_attend`` (reported: in bfloat16 that route rounds
    its scores where the kernel keeps them in float32).  The plain route
    is taken by a cache that is not fresh: one slot holds a position past
    the prompt, which the causal mask excludes, so the function is the
    same.  ``batch``: token ids or frame embeddings, ``(B, S, ...)``.
    ``flash``: the flash kernel every layer must launch, ``"sm90"`` or
    ``"simple"``; by default the Hopper one for bfloat16, the simple one
    for float32."""
    from repro_torch.kernels import attention as fa, launch_counts
    from repro_torch.models import attention as attn

    B, S = next(iter(batch.values())).shape[:2]
    names = ("flash_attention", "flash_attention_sm90")

    def prefill(cache):
        before = launch_counts()
        logits, _ = model.prefill(params, batch, cache)
        torch.cuda.synchronize()
        after = launch_counts()
        return logits.float(), tuple(after[n] - before[n] for n in names)

    kernel, n_kernel = prefill(model.make_cache(B, SLOTS))
    attn.flash_attention = fa.flash_attention_ref
    try:
        plain, n_plain = prefill(model.make_cache(B, SLOTS))
    finally:
        attn.flash_attention = fa.flash_attention
    cache = model.make_cache(B, SLOTS)
    for seg in cache:
        for blk in seg.values():
            if "pos" in blk:        # an RG-LRU state has no slots
                blk["pos"][:, :, -1] = 2 ** 30
    route, n_route = prefill(cache)
    layers = attention_layers(model.cfg)
    # bfloat16 goes through the Hopper kernel, float32 the simple one,
    # unless the caller names the kernel
    if flash is None:
        flash = "sm90" if model.cfg.dtype == torch.bfloat16 else "simple"
    sm90 = layers if flash == "sm90" else 0
    require((n_kernel, n_plain, n_route) == ((layers, sm90), (0, 0), (0, 0)),
            f"logit check: (flash, sm90) launches "
            f"{(n_kernel, n_plain, n_route)}")
    require(bool(torch.isfinite(kernel).all())
            and kernel.shape == (B, model.cfg.vocab), "prefill logits")
    dtype = str(model.cfg.dtype).split(".")[-1]
    tol = LOGIT_TOL[dtype]
    top = plain.abs().max().item()
    err = (kernel - plain).abs().max().item()
    require(err <= tol * top, f"prefill logits ({dtype}), kernel vs its "
            f"plain version: max|err| {err} > {tol} * {top}")
    route_err = (kernel - route).abs().max().item()
    say(tag, check="prefill-logits", model=model.cfg.name, dtype=dtype,
        prompts=B, prompt_tokens=S, kernel="sm90" if sm90 else "simple",
        max_abs_logit=top,
        kernel_vs_plain_err=err, limit=f"{tol}*max|logit|",
        kernel_vs_attend_route_err=route_err,
        attend_route_rel=f"{route_err / top:.5f}",
        argmax_equal=bool(kernel.argmax() == plain.argmax()
                          == route.argmax()))


def profile_serving(torch, model, params, prompt, steps=8):
    """Where serving's time goes, on the served configuration: one
    profiled prefill of ``prompt`` and one profiled window of ``steps``
    decode steps with all 4 lanes busy -- host-clock ms, the device's
    busy ms (self device time of every device activity), its idle share
    ``1 - busy / window``, the flash kernel's share, and the aten
    operations one decode step dispatches."""
    from repro_torch.serving import Request, ServeEngine

    engine = ServeEngine(model, params, lanes=LANES, slots=SLOTS)
    endless = 10 ** 9
    by_name, window = device_activity(
        torch, lambda: engine.submit(Request(0, prompt, endless)))
    busy = sum(us for _, us in by_name.values()) / 1e3
    flash = sum(us for name, (_, us) in by_name.items()
                if "flash_attention_kernel" in name) / 1e3
    say("profile", serving="prefill", prompt_tokens=len(prompt),
        window_ms=f"{window * 1e3:.3f}", device_busy_ms=f"{busy:.4f}",
        idle_share=f"{1 - busy / (window * 1e3):.4f}",
        flash_ms=f"{flash:.4f}",
        device_activities=sum(c for c, _ in by_name.values()))
    for rid in range(1, LANES):
        engine.submit(Request(rid, prompt[:PROMPT_MIN], endless))
    with count_ops_mode()() as mode:
        engine.step()
    by_name, window = device_activity(
        torch, lambda: [engine.step() for _ in range(steps)])
    busy = sum(us for _, us in by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:4]
    say("profile", serving="decode", lanes=LANES, steps=steps,
        aten_ops_per_step=mode.count,
        window_ms_per_step=f"{window * 1e3 / steps:.4f}",
        device_busy_ms_per_step=f"{busy / steps:.5f}",
        idle_share=f"{1 - busy / (window * 1e3):.4f}",
        device_activities_per_step=sum(c for c, _ in by_name.values())
        / steps)
    for name, (count, us) in top:
        say("profile", serving="decode",
            device_ms_per_step=f"{us / 1e3 / steps:.5f}",
            per_step=count / steps, name=name[:70].replace(" ", "_"))


def ab_prefill(torch, model, params, prompt, rounds=2):
    """One prompt's prefill with the Hopper flash kernel (the main path)
    and with the simple kernel forced in its place, in turns (sm90,
    simple, simple, sm90, ...): host-clock ms of each synchronised
    prefill (fresh cache made outside the clock), then one profiled
    prefill of each -- device busy ms, idle share, the flash kernels'
    ms."""
    from repro_torch.kernels import attention as fa
    from repro_torch.models import attention as attn

    tokens = torch.as_tensor(prompt.astype(np.int64),
                             device=model.device)[None]
    kernels = {"sm90": fa.flash_attention,
               "simple": lambda q, k, v: fa.flash_attention_cuda(
                   q, k, v, kernel="simple")}

    def prefill(cache):
        model.prefill(params, {"tokens": tokens}, cache)
        torch.cuda.synchronize()

    host = {r: [] for r in kernels}
    try:
        for r in ("sm90", "simple", "simple", "sm90") * rounds:
            attn.flash_attention = kernels[r]
            cache = model.make_cache(1, SLOTS)
            torch.cuda.synchronize()
            t = time.perf_counter()
            prefill(cache)
            host[r].append((time.perf_counter() - t) * 1e3)
        for r in kernels:
            attn.flash_attention = kernels[r]
            # the profiler can miss part of a window: take it again until
            # it saw every layer's flash launch
            for attempt in range(1, 4):
                cache = model.make_cache(1, SLOTS)
                by_name, window = device_activity(torch,
                                                  lambda: prefill(cache))
                seen = sum(c for name, (c, _) in by_name.items()
                           if "flash_attention_kernel" in name)
                if seen == model.cfg.n_layers:
                    break
                say("profile", ab_prefill=r, window=attempt,
                    flash_launches_seen=seen, retry=attempt < 3)
            require(seen == model.cfg.n_layers,
                    f"profiled prefill ({r}) saw {seen} flash launches")
            busy = sum(us for _, us in by_name.values()) / 1e3
            flash = sum(us for name, (_, us) in by_name.items()
                        if "flash_attention_kernel" in name) / 1e3
            say("profile", ab_prefill=r, prompt_tokens=len(prompt),
                host_ms=[f"{ms:.3f}" for ms in host[r]],
                host_ms_mean=f"{np.mean(host[r]):.3f}",
                profiled_window_ms=f"{window * 1e3:.3f}",
                device_busy_ms=f"{busy:.4f}",
                idle_share=f"{1 - busy / (window * 1e3):.4f}",
                flash_ms=f"{flash:.4f}")
    finally:
        attn.flash_attention = fa.flash_attention


def serve_requests(torch, model, params, prompts, tag="serving",
                   flash="sm90"):
    """The served main path: ``ServeEngine.run`` of ``prompts``, MAX_NEW
    new tokens each, greedy, on LANES lanes of SLOTS slots (after a
    warm-up on an engine of its own), the launch counts reset before the
    run and read after it; every request and slot event checked, and
    every prompt pass of every attention layer (:func:`attention_layers`)
    a launch of the flash kernel named by ``flash``: the Hopper one
    (bfloat16 at dh 64 / 128 / 256 and MLA's q·k 192 / v 128), or the
    simple one (float32).  Prints the run's lines under
    ``tag`` (tokens/s, prefill ms per request, decode ms per 4-lane
    step) and returns the run's launch counts."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import Request, ServeEngine

    cfg = model.cfg
    # warm-up (cuBLAS, the kernel library) on an engine of its own
    ServeEngine(model, params, lanes=1, slots=SLOTS).run(
        [Request(-1, prompts[1][:PROMPT_MIN], 2)])

    batches = []
    engine = ServeEngine(model, params, lanes=LANES, slots=SLOTS,
                         event_sink=batches.append)
    prefill_ms, step_ms = [], []

    def timed(fn, log, keep=lambda out: True):
        def run(*args):
            t = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            if keep(out):
                log.append((time.perf_counter() - t) * 1e3)
            return out
        return run

    engine.submit = timed(engine.submit, prefill_ms, keep=bool)
    engine.step = timed(engine.step, step_ms)
    reqs = [Request(i, p, MAX_NEW) for i, p in enumerate(prompts)]
    n = len(reqs)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    done = engine.run(reqs)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    require(len(done) == n
            and all(len(r.out) == MAX_NEW and r.done for r in reqs)
            and all(0 <= t < cfg.vocab for r in reqs for t in r.out),
            f"{cfg.name} served: {len(done)} of {n} requests finished, "
            f"tokens {[len(r.out) for r in reqs]}")
    # bfloat16 prompts at dh 64 / 128 / 256 and MLA's 192 / 128 sit on
    # TMA's grid, so every prompt pass of every attention layer takes the
    # Hopper kernel
    layers = attention_layers(cfg)
    want = n * layers
    sm90 = want if flash == "sm90" else 0
    require(counts["flash_attention"] == want
            and counts["flash_attention_sm90"] == sm90,
            f"{cfg.name}: flash launches {counts['flash_attention']}, sm90 "
            f"{counts['flash_attention_sm90']}, want {n} x {layers} "
            f"on the {flash} kernel")
    events = [e for b in batches for e in b]
    for kind in ("acquire", "release"):
        require(sorted(e.rid for e in events if e.kind == kind)
                == list(range(n)), f"slot events {kind}: {events}")
    require(engine.events.pending == 0, "slot events left undelivered")
    tokens = sum(len(r.out) for r in reqs)
    say(tag, main_path="ok", model=cfg.name, requests=n, lanes=LANES,
        slots=SLOTS, prompt_tokens=[len(p) for p in prompts],
        new_tokens=tokens, launches=counts,
        events=len(events), seconds=f"{seconds:.4f}",
        tokens_per_s=f"{tokens / seconds:.2f}")
    say(tag, model=cfg.name,
        prefill_ms_per_request=[f"{ms:.3f}" for ms in prefill_ms],
        prefill_ms_mean=f"{np.mean(prefill_ms):.3f}",
        decode_ms_per_step=f"{np.mean(step_ms):.4f}",
        decode_steps=len(step_ms),
        decode_ms_min_max=f"{min(step_ms):.4f}/{max(step_ms):.4f}")
    return counts


def phase_serving(torch, device):
    """Phase 6.  The kernel against its plain version, then the main
    path: ``ServeEngine.run`` on tinyllama-1.1b at full width and depth
    (counts reset before it, read after it), every request and slot
    event checked; then one prefill's logits, kernel vs plain attention.
    Returns the records of the two flash kernels."""
    from repro_torch import configs
    from repro_torch.models.model import build_model

    records = check_flash(torch, device)
    cfg = configs.full(ARCH)
    model = build_model(cfg, device=device)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=device).manual_seed(0))
    torch.cuda.synchronize()
    say("serving", model=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
        heads=f"{cfg.n_heads}/{cfg.n_kv_heads}",
        dtype=str(cfg.dtype).split(".")[-1], params=cfg.num_params(params),
        init_s=f"{time.perf_counter() - t0:.2f}")
    prompts = serve_prompts(cfg.vocab)
    counts = serve_requests(torch, model, params, prompts)
    check_prefill_logits(torch, model, params,
                         prompt_batch(torch, model, prompts[0]))
    profile_serving(torch, model, params, prompts[0])
    ab_prefill(torch, model, params, prompts[0])
    # the same weights in float32: only the kernel's own rounding is left
    f32 = build_model(dataclasses.replace(cfg, dtype=torch.float32),
                      device=device)
    check_prefill_logits(torch, f32, f32.init(torch.Generator(
        device=device).manual_seed(0)), prompt_batch(torch, f32, prompts[0]))
    del f32
    # the wrapper's counter (either kernel) and the Hopper kernel's own
    records["flash_attention"]["launches"] = counts["flash_attention"]
    records["flash_attention"]["simple_kernel_launches"] = (
        counts["flash_attention"] - counts["flash_attention_sm90"])
    records["flash_attention_sm90"]["launches"] = \
        counts["flash_attention_sm90"]
    for name in ("flash_attention", "flash_attention_sm90"):
        records[name]["path_launches"] = {"serving": counts[name]}
    return records, model, params


# ---------------------------------------------------------------------------
# phase 8: the disaggregated serving tier (prefill and decode on disjoint
# kernel sets, one vectored-put KV migration per request)
# ---------------------------------------------------------------------------

N_PREFILL, N_DECODE = 2, 2  # benchmarks/bench_serving.py:91's split
LANES_PER_DECODE = LANES // N_DECODE
FRONT_QUEUE = 2             # tests/serving_checks.py:73's admission bound


def disagg_transport(lane_words: int, n_blocks: int):
    """TCP with a frame that holds one lane's migration: the payload, its
    in-packet address list and the header (vectored puts do not
    segment)."""
    from repro_torch.core import am
    from repro_torch.runtime import TCP

    return dataclasses.replace(
        TCP, max_packet_bytes=4 * (lane_words + n_blocks + am.HDR_WORDS))


def drive_frontend(fe, prompts, max_new):
    """``tests/serving_checks.py:72-97``'s sequence: every prompt
    submitted into the bounded queue, run to idle, then the rejected
    ones retried with a ``pump`` between attempts.  Returns the admitted
    jobs in admission order and how many submits were rejected."""
    from repro_torch.serving import REJECTED

    jobs = [fe.submit(p, max_new) for p in prompts]
    rejected = [j for j in jobs if j.status == REJECTED]
    fe.run_until_idle()
    pending, refused = [(j.request.prompt, max_new) for j in rejected], 0
    admitted = [j for j in jobs if j.status != REJECTED]
    while pending:
        job = fe.submit(*pending[0])
        if job.status == REJECTED:
            refused += 1
            fe.pump()
            continue
        pending.pop(0)
        admitted.append(job)
    fe.run_until_idle()
    return admitted, len(rejected) + refused


def _lane_equal(torch, got, want) -> bool:
    """Two (B=1) lane caches bitwise equal, leaf by leaf, dtypes too."""
    return len(got) == len(want) and all(
        g[key][name].dtype == w[key][name].dtype
        and torch.equal(_bits(torch, g[key][name]), _bits(torch, w[key][name]))
        for g, w in zip(got, want) for key in w for name in w[key])


def run_disagg(torch, model, params, prompts, transport, *, twin=False):
    """One tier (2 prefill + 2 decode kernels, 2 lanes each, 2048 slots)
    driven through ``ServeFrontend(max_queue=2)``.  Every migration is
    timed (synchronised, host clock), its exchanges counted and the lane
    cache ``unpack_lane`` rebuilt from the decode kernel's segment held
    bitwise to the prefill worker's.  ``twin``: the same tier and trace
    with ``adopt_lane`` handed the worker's lane cache directly (no
    migration).  Returns the tier, the front end, the admitted jobs, the
    rejections, the launch counts of the run and its timings."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import ServingSlices
    from repro_torch.serving import DisaggServeTier, ServeFrontend

    tier = DisaggServeTier(model, params, ServingSlices(N_PREFILL, N_DECODE),
                           lanes_per_decode=LANES_PER_DECODE, slots=SLOTS,
                           transport=transport, device=model.device)
    log = {"prefill": [], "step": [], "migrate": [], "exchanges": [],
           "round_trip": []}

    def timed(fn, key):
        def run(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            log[key].append((time.perf_counter() - t) * 1e3)
            return out
        return run

    for worker in tier.workers.values():
        worker.prefill = timed(worker.prefill, "prefill")
    tier.step = timed(tier.step, "step")
    migrate = timed(tier.migrate, "migrate")

    def migrate_checked(src, dst, lane, lane_cache):
        before = tier.ctx.exchanges
        adopted = migrate(src, dst, lane, lane_cache)
        log["exchanges"].append(tier.ctx.exchanges - before)
        log["round_trip"].append(_lane_equal(torch, adopted, lane_cache))
        return adopted

    tier.migrate = (lambda src, dst, lane, lane_cache: lane_cache) if twin \
        else migrate_checked
    fe = ServeFrontend(tier, max_queue=FRONT_QUEUE)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    admitted, rejections = drive_frontend(fe, prompts, MAX_NEW)
    torch.cuda.synchronize()
    log["seconds"] = time.perf_counter() - t0
    return tier, fe, admitted, rejections, launch_counts(), log


def check_migration_shapes(torch, device, kv):
    """Both DataMover designs at one migration's shapes, bitwise against
    the plain version and timed in turns: the egress gather of the fused
    packet (every kernel's row of ``lane_words`` words), the ragged
    gather that cuts it into the lane's blocks in ``ingress_vectored``,
    and the scatter that lands the blocks in the decode kernel's
    segment (one active row, the others NOP).  Inputs are seeded random
    words on the tier's own layout.  Returns each shape's measurements
    by (op, case)."""
    from repro_torch.kernels import am_pack as dm

    K, lw = N_PREFILL + N_DECODE, kv.lane_words
    seg_words = kv.ctx.segment_words
    sizes = [leaf.words for leaf in kv.leaves for _ in range(leaf.layers)]
    offs = np.cumsum([0] + sizes[:-1]).tolist()
    B, W = len(sizes), max(sizes)
    gen = torch.Generator(device=device).manual_seed(8)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=device)

    def i32(rows):
        return torch.tensor(rows, dtype=torch.int32, device=device)

    out, kw = {}, dict(floor=floor_ms(torch, device))
    payload = randn(K, lw)
    out["gather", "kv-migration-egress"] = check_gather(
        torch, dm, payload, i32([[0]] * K), i32([[lw]] * K), lw,
        f"kv-migration-egress-{K}x1x{lw}", **kw)
    out["gather", "kv-migration-blocks"] = check_gather(
        torch, dm, payload, i32([offs] * K), i32([sizes] * K), W,
        f"kv-migration-ragged-{K}x{B}x{W}", **kw)
    rows = dm.datamover_gather_ref(payload, i32([offs] * K),
                                   i32([sizes] * K), W)
    dst = N_PREFILL                       # the first decode kernel
    active = [[int(k == dst)] * B for k in range(K)]
    addrs = kv.block_addrs(LANES_PER_DECODE - 1, kernel=dst)
    out["scatter", "kv-migration"] = check_scatter(
        torch, dm, randn(K, seg_words), rows, i32([addrs] * K),
        i32([sizes] * K), i32([[1] * B] * K), i32(active),
        f"kv-migration-{K}x{B}x{W}-ragged", plain_reps=2, **kw)
    for (op, case), m in out.items():
        faster = min(m["design_ms"], key=m["design_ms"].get)
        say("disagg", kernel=f"datamover_{op}", case=case,
            route=m["route"], faster_in_this_call=faster,
            route_is_faster=faster == m["route"])
    return out


def phase_disagg(torch, model, params):
    """Phase 8.  The disaggregated tier on tinyllama-1.1b at full width
    and depth (the phase 6 model): 2 prefill + 2 decode kernels, 2
    lanes per decode kernel, 2048 slots, phase 6's 8 prompts and 32 new
    tokens through ``ServeFrontend(max_queue=2)`` (counts reset before
    the run, read after it).  Every admitted job done, 8 migrations at
    exactly 2 exchanges each, every landed lane bitwise the worker's,
    error words 0, the migration credits drained, 176 Hopper flash
    launches, every DataMover launch on its routed design; the tokens
    bitwise equal to a twin run without the migration.  Then the solo
    one-lane engine (recorded), one profiled migration, and both
    DataMover designs at the migration's shapes.  Returns the
    migration's DataMover records."""
    from repro_torch.kernels import am_pack as dm
    from repro_torch.serving import DONE, Request, ServeEngine
    from repro_torch.serving.disagg import _lane_words
    from repro_torch.serving.kv_space import MIGRATE_TOKEN

    cfg = model.cfg
    device = model.device
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    base_mb = torch.cuda.memory_allocated(device) / 2 ** 20
    prompts = serve_prompts(cfg.vocab)
    lane_words = _lane_words(model, SLOTS)
    n_blocks = 3 * cfg.n_layers
    transport = disagg_transport(lane_words, n_blocks)
    K = N_PREFILL + N_DECODE
    say("disagg", model=cfg.name, layers=cfg.n_layers,
        kernels=f"{N_PREFILL}+{N_DECODE}", lanes_per_decode=LANES_PER_DECODE,
        slots=SLOTS, lane_words=lane_words, blocks=n_blocks,
        lane_mb=f"{lane_words * 4 / 1e6:.1f}",
        max_packet_bytes=transport.max_packet_bytes,
        segment_mb=f"{K * LANES_PER_DECODE * lane_words * 4 / 1e6:.1f}",
        base_allocated_mb=f"{base_mb:.0f}")

    tier, fe, jobs, rejections, counts, log = run_disagg(
        torch, model, params, prompts, transport)
    stats = fe.stats()
    tokens = {j.rid: list(j.tokens) for j in jobs}
    require(len(jobs) == REQUESTS and all(j.status == DONE for j in jobs)
            and all(len(t) == MAX_NEW and all(0 <= x < cfg.vocab for x in t)
                    for t in tokens.values()),
            f"disagg: {len(jobs)} admitted, statuses "
            f"{[j.status for j in jobs]}")
    require(tier.migrations == REQUESTS, f"migrations {tier.migrations}")
    require(stats["peak_queue_depth"] <= FRONT_QUEUE
            and stats["busy_lanes"] == 0 and stats["queue_depth"] == 0,
            f"front end stats {stats}")
    require(rejections > 0, "no backpressure with a queue of 2")
    err = tier.state.error.cpu()
    credits = tier.state.credits[:, MIGRATE_TOKEN].cpu()
    require(bool((err == 0).all()) and bool((credits == 0).all()),
            f"error words {err.tolist()}, migration credits "
            f"{credits.tolist()}")
    require(log["exchanges"] == [2] * REQUESTS,
            f"exchanges per migration {log['exchanges']}")
    require(all(log["round_trip"]) and len(log["round_trip"]) == REQUESTS,
            f"unpack_lane vs the worker's lane cache: {log['round_trip']}")
    layers = cfg.n_layers
    require(counts["flash_attention"] == counts["flash_attention_sm90"]
            == REQUESTS * layers,
            f"flash launches {counts['flash_attention']}, sm90 "
            f"{counts['flash_attention_sm90']}, want {REQUESTS} x {layers}")
    # one migration: the fused packet's egress gather and the ragged
    # block gather, then the block scatter, each on its routed design
    sizes = [leaf.words for leaf in tier.kv.leaves
             for _ in range(leaf.layers)]
    want = {name: 0 for name in DM_COUNTERS.values()}
    for op, B, W in (("gather", 1, lane_words),
                     ("gather", n_blocks, max(sizes)),
                     ("scatter", n_blocks, max(sizes))):
        route = dm.datamover_kernel_for(op, K, B, W, torch.float32)
        want[DM_COUNTERS[op, route]] += REQUESTS
    got = {name: counts[name] for name in want}
    require(got == want, f"migration DataMover launches {got}, want {want}")
    say("disagg", main_path="ok", requests=REQUESTS, admitted=len(jobs),
        rejections=rejections, migrations=tier.migrations,
        exchanges_per_migration=sorted(set(log["exchanges"])),
        round_trip="bitwise", stats=json.dumps(stats), launches=counts,
        error_words=err.tolist(), migrate_credits=credits.tolist())
    new_tokens = sum(len(t) for t in tokens.values())
    say("disagg", seconds=f"{log['seconds']:.4f}", new_tokens=new_tokens,
        tokens_per_s=f"{new_tokens / log['seconds']:.2f}",
        prefill_ms_per_request=[f"{ms:.3f}" for ms in log["prefill"]],
        prefill_ms_mean=f"{np.mean(log['prefill']):.3f}",
        migrate_host_ms=[f"{ms:.3f}" for ms in log["migrate"]],
        migrate_host_ms_median=f"{np.median(log['migrate']):.3f}",
        decode_ms_per_step=f"{np.mean(log['step']):.4f}",
        decode_steps=len(log["step"]),
        decode_ms_min_max=f"{min(log['step']):.4f}/{max(log['step']):.4f}")
    # one more migration of a finished prefill, profiled: the device time
    # of moving one lane (every device activity of the call)
    src, dst = N_PREFILL - 1, N_PREFILL
    lane_cache = tier.workers[src].cache
    by_name, window = device_activity(
        torch, lambda: tier.migrate(src, dst, 0, lane_cache))
    busy = sum(us for _, us in by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:5]
    say("profile", disagg="migration", lane_mb=f"{lane_words * 4 / 1e6:.1f}",
        window_ms=f"{window * 1e3:.3f}", device_ms_per_lane=f"{busy:.4f}",
        idle_share=f"{1 - busy / (window * 1e3):.4f}",
        device_activities=sum(c for c, _ in by_name.values()),
        top=json.dumps({name[:48]: [c, round(us / 1e3, 5)]
                        for name, (c, us) in top}))
    # phase 10's full-width lint: one more migration under a recorder
    from repro_torch.analysis.lint import record_run, report_of

    before = tier.ctx.exchanges
    t0 = time.perf_counter()
    _, rec = record_run(tier.migrate, src, dst, 0, lane_cache)
    torch.cuda.synchronize()
    lint_ms = (time.perf_counter() - t0) * 1e3
    rep = report_of(rec, "kv-migrate-full")
    require(rep.ok and tier.ctx.exchanges - before == rec.exchanges == 2,
            f"full-width migration lint: {tier.ctx.exchanges - before} "
            f"exchanges ({rec.tags})\n{rep.render()}")
    say("lint", entry="kv-migrate-full", lane_mb=f"{lane_words * 4 / 1e6:.1f}",
        clean=True, events=rep.n_events, exchanges=rec.exchanges,
        tags=json.dumps(rec.tags), run_ms=f"{lint_ms:.3f}")
    peak_mb = torch.cuda.max_memory_allocated(device) / 2 ** 20
    say("disagg", peak_allocated_mb=f"{peak_mb:.0f}",
        peak_over_base_mb=f"{peak_mb - base_mb:.0f}")
    kv = tier.kv
    del tier, fe, lane_cache
    torch.cuda.empty_cache()

    # the twin: the same tier and trace, the worker's lane adopted as is
    _, _, twin_jobs, twin_rej, twin_counts, twin_log = run_disagg(
        torch, model, params, prompts, transport, twin=True)
    twin_tokens = {j.rid: list(j.tokens) for j in twin_jobs}
    require(twin_tokens == tokens and twin_rej == rejections,
            "tokens differ from the twin run without the migration: "
            f"{sum(twin_tokens.get(r) != t for r, t in tokens.items())} "
            "requests")
    say("disagg", twin="tokens bitwise equal", requests=len(twin_tokens),
        twin_seconds=f"{twin_log['seconds']:.4f}",
        twin_decode_ms_per_step=f"{np.mean(twin_log['step']):.4f}",
        twin_launches=twin_counts)
    torch.cuda.empty_cache()

    # recorded, not required: the solo one-lane engine's tokens (cuBLAS
    # may pick other kernels for another batch size)
    solo = ServeEngine(model, params, lanes=1, slots=SLOTS)
    same = 0
    for job in jobs:
        ref = Request(job.rid, job.request.prompt, MAX_NEW)
        solo.run([ref])
        same += ref.out == tokens[job.rid]
    del solo
    say("disagg", solo_engine_same_tokens=f"{same}/{len(jobs)}")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    shapes = check_migration_shapes(torch, device, kv)
    say("disagg", migration_shapes_seconds=f"{time.perf_counter() - t0:.1f}")
    records = []
    for (op, case), m in shapes.items():
        name = DM_COUNTERS[op, m["route"]]
        rec = entry(name, DM_SRC[m["route"]], DM_TPU[op], m)
        rec.update(launches=counts[name], case=m["case"],
                   main_path_route=m["route"],
                   sm90_ms=m["design_ms"].get("sm90"),
                   simple_ms=m["design_ms"].get("simple"),
                   floor_ms=m["floor"], turns_ms=m["turns_ms"])
        records.append(rec)
    return records


# ---------------------------------------------------------------------------
# phase 9: the data-parallel trainer (K members on the kernel axis, every
# gradient leaf through the ring kernel)
# ---------------------------------------------------------------------------

TRAIN_K, TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 4, 8, 512, 1e-3
TRAIN_STEPS = 5
CKPT_LAYERS = 2             # the checkpoint and compressed checks' depth
# shoal vs xla gradient, relative L2 per leaf: both sum the same four
# bf16 member gradients in float32 (in different orders) and round once
# to bf16; the card read 3.4e-7 at the worst leaf
GRAD_TOL = 1e-5
LOSS_TOL = 1e-3             # shoal vs xla loss, relative
INT8_TOL = 5e-2             # tests/md_checks.py:485-490, after one step


def _synced(fn):
    """``fn`` timed on the host clock, synchronised: (wrapper, log)."""
    import torch

    log = []

    def run(*args, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        log.append((time.perf_counter() - t) * 1e3)
        return out
    return run, log


def _plain_all_reduce(torch, x):
    """``coll.ring_all_reduce``'s result from the ring's plain version
    (``kernels/gascore_dma/ref.py``) on the same padded buffer."""
    from repro_torch.kernels import gascore_dma as gd

    n = x.shape[0]
    buf = ring_buffer(torch, x, n)
    full = gd.ring_collective_ref(buf, gd.ALL_REDUCE).reshape(n, -1)
    return full[:, :x[0].numel()].reshape(x.shape)


def _ring_checked(torch, coll, log):
    """Wrap ``coll.ring_all_reduce``: every result bitwise the plain
    ring's on the same input, its K rows bitwise equal, an int32 result
    equal to the int64 sum of its payloads; ``log`` gets (dtype, words,
    the input of a one-word-a-row call) per call.  Returns the
    original."""
    real = coll.ring_all_reduce

    def checked(ctx, x):
        out = real(ctx, x)
        what = f"ring_all_reduce of {tuple(x.shape)} {x.dtype}"
        require(torch.equal(out, _plain_all_reduce(torch, x)),
                f"{what}: differs from the plain ring")
        require(torch.equal(out, out[:1].expand_as(out)), f"{what}: rows "
                "differ")
        if x.dtype == torch.int32:
            require(torch.equal(out[0], x.sum(0, dtype=torch.int64).to(
                torch.int32)), f"{what}: differs from the int64 sum")
        words = x[0].numel()
        log.append((str(x.dtype).split(".")[-1], words,
                    x.clone() if words == 1 else None))
        return out

    coll.ring_all_reduce = checked
    return real


def _rel_l2(torch, got, want):
    return (torch.linalg.vector_norm((got.float() - want.float()).flatten())
            / torch.linalg.vector_norm(want.float().flatten()).clamp_min(
                1e-30)).item()


def check_train_grads(torch, tr, tx, state, batch, tag="train"):
    """The first batch's gradients at the initial weights: the shoal
    members' synced mean (every leaf's ring result bitwise the plain
    ring's, its K rows bitwise equal) against the xla backend's with 4
    microbatches (the same row slices)."""
    from repro_torch.core import collectives as coll
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.tree import tree_paths

    log = []
    real = _ring_checked(torch, coll, log)
    try:
        before = tr.ctx.exchanges
        reset_launch_counts()
        loss_s, g_s, _ = tr.grads(state, batch)
        launches = launch_counts()
        exchanges = tr.ctx.exchanges - before
    finally:
        coll.ring_all_reduce = real
    loss_x, g_x, _ = tx.grads(state, batch)
    leaves = len(tree_paths(g_s))
    require(len(log) == leaves and exchanges == leaves * 2 * (TRAIN_K - 1),
            f"shoal sync: {len(log)} ring calls, {exchanges} exchanges for "
            f"{leaves} leaves")
    rel_loss = abs(loss_s.item() - loss_x.item()) / abs(loss_x.item())
    require(rel_loss <= LOSS_TOL, f"shoal loss {loss_s.item()} vs xla "
            f"{loss_x.item()}: relative {rel_loss}")
    errs = {path: _rel_l2(torch, a, b) for (path, a), (_, b)
            in zip(tree_paths(g_s), tree_paths(g_x))}
    worst = max(errs, key=errs.get)
    require(errs[worst] <= GRAD_TOL, f"shoal vs xla gradient {worst}: "
            f"relative L2 {errs[worst]}")
    say(tag, check="grads", loss_shoal=f"{loss_s.item():.6f}",
        loss_xla_mb4=f"{loss_x.item():.6f}", loss_rel=f"{rel_loss:.3e}",
        grad_rel_l2_max=f"{errs[worst]:.3e}", worst_leaf=worst,
        rows="bitwise equal", ring_vs_plain="bitwise equal", leaves=leaves,
        exchanges=exchanges,
        ring_calls=len(log), launches=launches)
    return launches


def check_train_compressed(torch, model, batch):
    """One compressed shoal step against one uncompressed, from the same
    weights: the ring results bitwise the plain ring's and the int32
    sums exact, 2(K - 1) more exchanges per leaf for the scale; the
    dequantised synced gradient within the int8 bound of the
    uncompressed one, and the parameters after the update within the
    reference's bound.

    The int8 bound, per leaf, from the members' scales ``s_k`` (``q_k s_k
    = g_k + e_k`` with ``|e_k| <= s_k / 2``, ``|q_k| <= 127``, and the
    sync dequantises with the mean scale ``s``): ``|sum_k q_k s / K -
    mean_k g_k| <= mean_k(127 |s - s_k| + s_k / 2)``, plus the bf16
    rounding of the uncompressed gradient, ``2^-8 |g|``."""
    from repro_torch.core import collectives as coll
    from repro_torch.optim import AdamWConfig
    from repro_torch.training import Trainer, TrainerConfig
    from repro_torch.tree import tree_paths

    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    grads, out, exch = {}, {}, {}
    for comp in (False, True):
        tr = Trainer(model, AdamWConfig(lr=TRAIN_LR),
                     TrainerConfig(comm_backend="shoal",
                                   grad_compression=comp), kernels=TRAIN_K)
        st = tr.state_for(params)
        log = []
        real = _ring_checked(torch, coll, log)
        try:
            loss, grads[comp], res = tr.grads(st, batch)
        finally:
            coll.ring_all_reduce = real
        out[comp], _ = tr.apply_update(st, grads[comp], loss, res)
        exch[comp] = (tr.ctx.exchanges, log)
        del tr, st, res
    leaves = len(tree_paths(params))
    per_leaf = 2 * (TRAIN_K - 1)
    require(exch[False][0] == leaves * per_leaf
            and exch[True][0] == 2 * leaves * per_leaf,
            f"exchanges {exch[False][0]} / {exch[True][0]} for {leaves} "
            "leaves")
    log = exch[True][1]
    require([d for d, _, _ in log] == ["int32", "float32"] * leaves,
            f"compressed ring calls {[d for d, _, _ in log]}")
    ratios = {}
    for i, ((path, got), (_, want)) in enumerate(zip(
            tree_paths(grads[True]), tree_paths(grads[False]))):
        s_k = log[2 * i + 1][2][:, 0].double()
        s = s_k.mean()
        limit = ((127 * (s - s_k).abs() + s_k / 2).mean()
                 + 2.0 ** -8 * want.double().abs())
        err = (got.double() - want.double()).abs()
        ratios[path] = (err / limit).max().item()
        require(ratios[path] <= 1.0, f"compressed gradient {path}: "
                f"{ratios[path]} of its int8 bound")
    worst = max(ratios, key=ratios.get)
    diff = max((a.float() - b.float()).abs().max().item() for (_, a), (_, b)
               in zip(tree_paths(out[True].params),
                      tree_paths(out[False].params)))
    require(diff < INT8_TOL, f"compressed step's params differ by {diff}")
    say("train", check="int8", layers=model.cfg.n_layers,
        exchanges=f"{exch[False][0]}->{exch[True][0]}",
        int32_sums="exact", ring_vs_plain="bitwise equal",
        rows="bitwise equal", grad_err_over_bound_max=f"{ratios[worst]:.3e}",
        worst_leaf=worst, param_max_abs_diff=f"{diff:.3e}",
        param_bound=INT8_TOL)


def check_train_checkpoint(torch, model, batch):
    """Save after step 2, restore into a fresh trainer: step 3's loss
    and parameters bitwise the uninterrupted run's."""
    import shutil
    import tempfile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.optim import AdamWConfig
    from repro_torch.training import Trainer, TrainerConfig
    from repro_torch.tree import tree_paths

    def trainer():
        return Trainer(model, AdamWConfig(lr=TRAIN_LR),
                       TrainerConfig(comm_backend="shoal"), kernels=TRAIN_K)

    tr = trainer()
    st = tr.init_state(torch.Generator(device=model.device).manual_seed(0))
    for _ in range(2):
        st, _ = tr.step(st, batch)
    d = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        mgr = CheckpointManager(d)
        t0 = time.perf_counter()
        mgr.save(2, st, extras={"data_step": 2})
        save_s = time.perf_counter() - t0
        want, met = tr.step(st, batch)
        del st
        fresh = trainer()
        t0 = time.perf_counter()
        back, extras = mgr.restore(fresh.init_state(torch.Generator(
            device=model.device).manual_seed(1)), verify=True)
        restore_s = time.perf_counter() - t0
        got, met2 = fresh.step(back, batch)
        nbytes = sum(os.path.getsize(os.path.join(d, "step_00000002", f))
                     for f in os.listdir(os.path.join(d, "step_00000002")))
    finally:
        shutil.rmtree(d, ignore_errors=True)
    require(extras == {"data_step": 2} and int(back.step) == 2,
            f"restored step {int(back.step)}, extras {extras}")
    require(torch.equal(met["loss"], met2["loss"]),
            f"step 3 loss {met['loss'].item()} after restore "
            f"{met2['loss'].item()}")
    for (path, a), (_, b) in zip(tree_paths(got.params),
                                 tree_paths(want.params)):
        require(torch.equal(a, b), f"step 3 {path} differs after restore")
    say("train", check="checkpoint", layers=model.cfg.n_layers,
        step3_loss=f"{met2['loss'].item():.6f}", bitwise="loss and params",
        checkpoint_mb=f"{nbytes / 1e6:.1f}", save_s=f"{save_s:.2f}",
        restore_verified_s=f"{restore_s:.2f}", removed=not os.path.exists(d))


def time_train_ring(torch, device, words, tag="train", case="largest-leaf"):
    """The ring all-reduce at the trainer's largest leaf, ``(K, words)``
    float32 from seed 9, as the shoal sync hands it to the kernel (see
    :func:`time_ring`), timed by CUDA events: at these leaves the
    profiler lost launches of the ring kernel (8 of 20 seen in each of 6
    windows at musicgen-medium's 453 M-word leaf, 0 of 5 at
    tinyllama-1.1b's), and each call is 2.7 ms or more of device work
    against tens of microseconds of host work.  Returns (route,
    measures)."""
    from repro_torch.kernels import gascore_dma as gd

    gen = torch.Generator(device=device).manual_seed(9)
    x = torch.randn(TRAIN_K, words, generator=gen, device=device)
    return time_ring(torch, x, gd.ALL_REDUCE, tag, case, events=True)


def time_ring(torch, x, schedule, tag, case, events=False):
    """The ring kernel on ``x (K, ...)`` as ``core.collectives`` hands
    it the ``schedule``: the routed kernel against the plain version
    (bitwise), device ms of the kernel and the library call in turns
    (kernel, library, library, kernel), of the plain version alone: by
    ``torch.profiler``, or with ``events`` by CUDA events around
    back-to-back calls (:func:`call_ms`; device time where the calls
    are device-bound).  The library call: the sum over the kernels
    expanded and copied (all-reduce), the sum of every kernel's chunks
    (reduce-scatter), the rows joined and copied to every kernel
    (all-gather).  Returns (route, measures)."""
    from repro_torch.kernels import gascore_dma as gd

    n = x.shape[0]
    if schedule == gd.ALL_GATHER:
        buf = x.reshape(n, -1).contiguous()
        lib = lambda: buf.reshape(1, -1).expand(n, -1).contiguous()  # noqa
        nbytes, ops = (1 + n) * buf.nbytes, 0
    else:
        buf = ring_buffer(torch, x, n)
        ops = (n - 1) * buf[0].numel()
        if schedule == gd.ALL_REDUCE:
            lib = lambda: x.sum(0, keepdim=True).expand_as(x).contiguous()  # noqa
            nbytes = 2 * buf.nbytes
        else:
            lib = lambda: buf.sum(0)  # noqa: E731
            nbytes = buf.nbytes + buf.nbytes // n
    route = gd.ring_kernel_for(n, buf.shape[-1], buf.dtype, schedule)
    kernel = lambda: gd.ring_collective_cuda(buf, schedule,  # noqa: E731
                                             kernel=route)
    plain = lambda: gd.ring_collective_ref(buf, schedule)  # noqa: E731
    got, want = kernel(), plain()
    require(torch.equal(got, want), f"ring kernel ({route}) {schedule} at "
            f"{case} differs from the plain version")
    err = 0.0       # bitwise equal, as required (no float64 copies: at
    del got, want   # recurrentgemma's 4 x 655 M-word leaf each is 21 GB)
    sub = "ring_cluster_kernel_sm90" if route == "sm90" else "ring_kernel"
    turns = {"kernel": [], "library": []}
    for r in ("kernel", "library", "library", "kernel"):
        fn = kernel if r == "kernel" else lib
        turns[r].append(call_ms(fn, reps=10, warmup=2) if events else
                        device_ms(fn, kernel=sub if r == "kernel" else None))
    m = dict(err=err, nbytes=nbytes, ops=ops,
             ms=float(np.mean(turns["kernel"])),
             plain=(call_ms(plain, reps=3, warmup=1) if events
                    else device_ms(plain, reps=3, warmup=1)),
             lib=float(np.mean(turns["library"])))
    name = {gd.ALL_REDUCE: "ring_all_reduce", gd.ALL_GATHER: "ring_all_gather",
            gd.REDUCE_SCATTER: "ring_reduce_scatter"}[schedule]
    say(tag, kernel=name, case=case, shape=tuple(buf.shape),
        dtype=str(buf.dtype).split(".")[-1], route=route, bitwise="equal",
        ms=f"{m['ms']:.5f}", plain_ms=f"{m['plain']:.5f}",
        library_ms=f"{m['lib']:.5f}",
        bound_ms=f"{bound(m)[0]:.5f}", bound_by=bound(m)[1],
        timer="cuda-events" if events else "profiler",
        turns_ms=json.dumps({r: [round(t, 5) for t in v]
                             for r, v in turns.items()}),
        card=card_line())
    return route, m


def phase_train(torch, device, cfg=None, batch_rows=TRAIN_BATCH,
                seq=TRAIN_SEQ, ckpt_layers=CKPT_LAYERS, tag="train",
                steps=TRAIN_STEPS, exchanges_per_step=None, extras=True,
                lr=TRAIN_LR):
    """Phase 9.  tinyllama-1.1b at full width and depth (bf16, seed 0),
    ``TokenPipeline(vocab, 8, 512, seed 0)``'s first batch, the shoal
    backend on K = 4 members, AdamW lr 1e-3.  The first batch's
    gradients against the xla backend's (4 microbatches); then the main
    path: 5 shoal steps on that batch (counts reset before them, read
    after), every step 12 ring launches and 72 exchanges, losses finite
    and falling; a timed breakdown step and a profiled step; then, with
    ``extras``, the xla backend's steps timed, at ``ckpt_layers``
    layers one compressed step and a checkpoint round trip, and the
    ring alone at the largest leaf.  Phase 11 trains its models through
    the same function (``cfg``, ``tag``, ``steps``, the JAX package's
    ``exchanges_per_step``, ``lr``: a float or a schedule; frame
    embeddings for the audio family).
    Returns the main path's launch counts and, with ``extras``, the
    largest leaf's ring record for the JSON line."""
    from repro_torch import configs
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.model import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.training import Trainer, TrainerConfig
    from repro_torch.tree import tree_leaves

    cuda = device.type == "cuda"
    cfg = configs.full(ARCH) if cfg is None else cfg
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    base_mb = torch.cuda.memory_allocated(device) / 2 ** 20
    model = build_model(cfg, device=device)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=device).manual_seed(0))
    kind = "embeddings" if cfg.frontend == "embeddings" else "tokens"
    batch, _ = TokenPipeline(DataConfig(vocab=cfg.vocab, batch=batch_rows,
                                        seq=seq, seed=0, kind=kind,
                                        d_model=cfg.d_model),
                             device=device).next_batch(0)
    opt = AdamWConfig(lr=lr)
    tr = Trainer(model, opt, TrainerConfig(comm_backend="shoal"),
                 kernels=TRAIN_K)
    tx = Trainer(model, opt, TrainerConfig(microbatches=TRAIN_K))
    state = tr.state_for(params)
    del params
    torch.cuda.synchronize()
    leaves = len(tree_leaves(state.params))
    words = sum(p.numel() for p in tree_leaves(state.params))
    tokens = batch_rows * seq
    say(tag, model=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
        dtype=str(cfg.dtype).split(".")[-1], params=words, leaves=leaves,
        kernels=TRAIN_K, batch=batch_rows, seq=seq, frontend=kind,
        tokens_per_step=tokens, init_s=f"{time.perf_counter() - t0:.2f}",
        base_allocated_mb=f"{base_mb:.0f}")
    per_leaf = 2 * (TRAIN_K - 1)
    if exchanges_per_step is not None:
        require(exchanges_per_step == leaves * per_leaf,
                f"{cfg.name}: {leaves} leaves x {per_leaf} exchanges, the "
                f"JAX step's {exchanges_per_step}")

    check_train_grads(torch, tr, tx, state, batch, tag)
    del tx
    torch.cuda.empty_cache()

    # the main path
    torch.cuda.synchronize()
    reset_launch_counts()
    ex0 = tr.ctx.exchanges
    losses, step_ms, per_step = [], [], []
    for _ in range(steps):
        before = launch_counts()
        t = time.perf_counter()
        state, met = tr.step(state, batch)
        losses.append(met["loss"].item())          # synchronises
        step_ms.append((time.perf_counter() - t) * 1e3)
        per_step.append(launch_counts()["ring_collective"]
                        - before["ring_collective"])
    counts = launch_counts()
    exchanges = tr.ctx.exchanges - ex0
    require(all(np.isfinite(losses)) and losses[-1] < losses[0],
            f"train losses {losses}")
    require(exchanges == steps * leaves * per_leaf,
            f"{exchanges} exchanges in {steps} steps")
    if cuda:
        from repro_torch.kernels import gascore_dma as gd

        sm90 = sum(gd.ring_kernel_for(TRAIN_K, -(-p.numel() // TRAIN_K),
                                      torch.float32, gd.ALL_REDUCE) == "sm90"
                   for p in tree_leaves(state.params))
        require(per_step == [leaves] * steps
                and counts["ring_cluster_sm90"] == steps * sm90
                and counts["flash_attention"] == 0,
                f"ring launches per step {per_step} (want {leaves}), "
                f"cluster {counts['ring_cluster_sm90']} (want "
                f"{steps} x {sm90}), flash {counts['flash_attention']}")
    ms = float(np.median(step_ms[1:]))
    say(tag, main_path="ok", model=cfg.name, backend="shoal",
        card=card_line(), losses=[f"{v:.5f}" for v in losses],
        ms_per_step=[f"{v:.2f}" for v in step_ms],
        ms_per_step_median_2_on=f"{ms:.2f}",
        tokens_per_s=f"{tokens / ms * 1e3:.1f}",
        ring_launches_per_step=per_step, exchanges_per_step=exchanges
        // steps, launches=counts)

    if extras:
        # xla backend (4 microbatches), timed the same way
        tx = Trainer(model, opt, TrainerConfig(microbatches=TRAIN_K))
        xs, x_ms = state, []
        for _ in range(steps):
            t = time.perf_counter()
            xs, xmet = tx.step(xs, batch)
            xmet["loss"].item()
            x_ms.append((time.perf_counter() - t) * 1e3)
        del xs, tx
        xms = float(np.median(x_ms[1:]))
        say(tag, backend="xla", microbatches=TRAIN_K,
            ms_per_step=[f"{v:.2f}" for v in x_ms],
            ms_per_step_median_2_on=f"{xms:.2f}",
            tokens_per_s=f"{tokens / xms * 1e3:.1f}")

    # one step timed by part (synchronised between parts)
    tr.member_grads, fb_log = _synced(tr.member_grads)
    tr.sync, sync_log = _synced(tr.sync)
    tr.apply_update, opt_log = _synced(tr.apply_update)
    state, _ = tr.step(state, batch)
    del tr.member_grads, tr.sync, tr.apply_update
    # one step profiled: device busy, idle share, ring device ms by route
    by_name, window = device_activity(
        torch, lambda: tr.step(state, batch)[1]["loss"].item())
    busy = sum(us for _, us in by_name.values()) / 1e3
    ring = {route: [sum(c for n, (c, _) in by_name.items() if sub in n),
                    sum(us for n, (_, us) in by_name.items() if sub in n)
                    / 1e3]
            for route, sub in (("simple", "ring_kernel"),
                               ("sm90", "ring_cluster_kernel_sm90"))}
    ring_bytes = sum(2 * TRAIN_K * p.numel() * 4
                     for p in tree_leaves(state.params))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    say(tag, model=cfg.name, breakdown_ms=json.dumps({
        "members_fwd_bwd": round(fb_log[0], 3),
        "sync": round(sync_log[0], 3), "adamw": round(opt_log[0], 3)}),
        ring_device_ms=json.dumps({r: round(v[1], 5)
                                   for r, v in ring.items()}),
        ring_device_launches=json.dumps({r: v[0] for r, v in ring.items()}),
        ring_bound_ms=f"{ring_bytes / HBM_BPS * 1e3:.4f}",
        profiled_window_ms=f"{window * 1e3:.2f}",
        device_busy_ms=f"{busy:.3f}",
        idle_share=f"{1 - busy / (window * 1e3):.4f}",
        device_activities=sum(c for c, _ in by_name.values()))
    say(tag, top_device_ms=json.dumps([[name[:110], c, round(us / 1e3, 4)]
                                       for name, (c, us) in top]))
    peak_mb = torch.cuda.max_memory_allocated(device) / 2 ** 20
    say(tag, model=cfg.name, peak_allocated_mb=f"{peak_mb:.0f}",
        peak_over_base_mb=f"{peak_mb - base_mb:.0f}")
    largest = max(p.numel() for p in tree_leaves(state.params))
    del state, model, tr
    torch.cuda.empty_cache()
    route, m = time_train_ring(torch, device, largest, tag,
                               f"{cfg.name}-largest-leaf")
    torch.cuda.empty_cache()
    if route == "sm90":
        rec = entry("ring_cluster_sm90", RING_SM90_SRC, RING_TPU, m)
        rec["launches"] = counts["ring_cluster_sm90"]
    else:
        rec = entry("ring_collective", RING_SRC, RING_TPU, m)
        rec["launches"] = (counts["ring_collective"]
                           - counts["ring_cluster_sm90"])
    rec.update(case=f"all_reduce-{tag}-{cfg.name}-largest-leaf-f32",
               main_path_route=route,
               path_launches={tag: rec["launches"]})
    if not extras:
        return counts, rec

    small = build_model(dataclasses.replace(cfg, n_layers=ckpt_layers),
                        device=device)
    check_train_compressed(torch, small, batch)
    torch.cuda.empty_cache()
    check_train_checkpoint(torch, small, batch)
    del small
    torch.cuda.empty_cache()
    return counts, rec


# ---------------------------------------------------------------------------
# phase 11: the dense and audio families (qwen2-1.5b and deepseek-7b served
# and trained, musicgen-medium's frame-embedding frontend)
# ---------------------------------------------------------------------------

FAMILY_SERVED = ("qwen2-1.5b", "deepseek-7b")
MUSIC = "musicgen-medium"
MUSIC_B, MUSIC_S, MUSIC_DECODE = 4, 1024, 32
# shoal exchanges a step at K = 4: the JAX package's compiled step on the
# reduced configs (tests/test_torch_models.py), one ring of 2(K - 1)
# collective-permutes a parameter leaf (qwen2's tied embedding is one
# leaf; musicgen's unread token embedding is all-reduced as zeros)
JAX_SHOAL_EXCHANGES = {"qwen2-1.5b": 84, "deepseek-7b": 72,
                       "musicgen-medium": 96}
# deepseek-7b is trained at full width but not full depth: its embedding
# and head alone are 0.84 B parameters, and at phase 9's ~37 bytes per
# trained parameter 4 of its 30 layers fit the card beside them
DEEPSEEK_TRAIN_LAYERS, DEEPSEEK_TRAIN_STEPS = 4, 2
# phase 11's trainers take launch/train.py's default schedule (--lr 3e-4
# --warmup 10 --steps 100): at these widths a constant 1e-3 (phase 9's)
# overshoots from the first Adam step -- qwen2-1.5b's loss went 11.78,
# 11.10, 11.96, 11.08, 17.24 on the card -- and the JAX package's
# trainer oscillates there as well
FAMILY_LR = (3e-4, 10, 100)


def _free(torch):
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _init(torch, device, cfg, tag):
    """The model of ``cfg`` on the card and its random weights (seed 0)."""
    from repro_torch.models.model import build_model

    model = build_model(cfg, device=device)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=device).manual_seed(0))
    torch.cuda.synchronize()
    say(tag, model=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
        heads=f"{cfg.n_heads}/{cfg.n_kv_heads}", d_ff=cfg.d_ff,
        vocab=cfg.vocab, dtype=str(cfg.dtype).split(".")[-1],
        params=cfg.num_params(params),
        init_s=f"{time.perf_counter() - t0:.2f}",
        allocated_mb=f"{torch.cuda.memory_allocated(device) / 2 ** 20:.0f}")
    return model, params


def serve_family(torch, device, arch):
    """``arch`` at full width and depth (bf16, seed 0) served as phase 6
    serves tinyllama-1.1b: 8 requests of 128-1024 prompt tokens, 32 new
    tokens each, 4 lanes of 2048 slots, every prompt pass of every layer
    on the Hopper flash kernel (requests x layers launches); one
    prefill's logits, kernel vs plain version (qwen2-1.5b also in
    float32 through the simple kernel).  Returns the run's counts."""
    from repro_torch import configs
    from repro_torch.models.model import build_model

    cfg = configs.full(arch)
    model, params = _init(torch, device, cfg, "dense")
    prompts = serve_prompts(cfg.vocab)
    counts = serve_requests(torch, model, params, prompts, "dense")
    check_prefill_logits(torch, model, params,
                         prompt_batch(torch, model, prompts[0]), "dense")
    del params
    _free(torch)
    if arch == "qwen2-1.5b":
        f32 = build_model(dataclasses.replace(cfg, dtype=torch.float32),
                          device=device)
        check_prefill_logits(torch, f32, f32.init(torch.Generator(
            device=device).manual_seed(0)),
            prompt_batch(torch, f32, prompts[0]), "dense")
        del f32
        _free(torch)
    return counts


def serve_frames(torch, device):
    """musicgen-medium at full width and depth (bf16, seed 0) through
    ``Model.prefill`` / ``decode_step`` with seeded frame embeddings:
    one prefill of 4 x 1024 frames (one Hopper flash launch per layer),
    then 32 decode steps of 4 lanes fed (4, 1, d) frames (no flash);
    host ms of each, synchronised; then the prefill's logits, kernel vs
    plain version.  Returns the run's counts."""
    from repro_torch import configs
    from repro_torch.kernels import launch_counts, reset_launch_counts

    cfg = configs.full(MUSIC)
    model, params = _init(torch, device, cfg, "audio")
    gen = torch.Generator(device=device).manual_seed(13)
    d = cfg.d_model
    frames = torch.randn(MUSIC_B, MUSIC_S, d, generator=gen,
                         device=device) * 0.02
    steps = torch.randn(MUSIC_DECODE, MUSIC_B, 1, d, generator=gen,
                        device=device) * 0.02
    # warm-up on a short prompt and one step
    cache = model.make_cache(1, SLOTS)
    model.prefill(params, {"embeddings": frames[:1, :PROMPT_MIN]}, cache)
    model.decode_step(params, cache, steps[0, :1],
                      torch.full((1,), PROMPT_MIN, device=device))
    cache = model.make_cache(MUSIC_B, SLOTS)
    _free(torch)
    reset_launch_counts()
    t = time.perf_counter()
    logits, cache = model.prefill(params, {"embeddings": frames}, cache)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t) * 1e3
    after_prefill = launch_counts()["flash_attention_sm90"]
    pos = torch.full((MUSIC_B,), MUSIC_S, device=device)
    step_ms, outs = [], [logits]
    for i in range(MUSIC_DECODE):
        t = time.perf_counter()
        logits, cache = model.decode_step(params, cache, steps[i], pos + i)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        outs.append(logits)
    counts = launch_counts()
    out = torch.stack(outs)
    require(counts["flash_attention"] == counts["flash_attention_sm90"]
            == after_prefill == cfg.n_layers,
            f"{cfg.name}: flash launches {counts['flash_attention']}, sm90 "
            f"{counts['flash_attention_sm90']} ({after_prefill} after the "
            f"prefill), want {cfg.n_layers} for the one prompt pass")
    require(out.shape == (MUSIC_DECODE + 1, MUSIC_B, cfg.vocab)
            and bool(torch.isfinite(out).all()),
            f"{cfg.name}: logits {tuple(out.shape)}, finite "
            f"{bool(torch.isfinite(out).all())}")
    frames_out = MUSIC_B * MUSIC_DECODE
    say("audio", main_path="ok", model=cfg.name, prompts=MUSIC_B,
        prompt_frames=MUSIC_S, decode_steps=MUSIC_DECODE, slots=SLOTS,
        launches=counts, prefill_ms=f"{prefill_ms:.3f}",
        decode_ms_per_step=f"{np.mean(step_ms):.4f}",
        decode_ms_min_max=f"{min(step_ms):.4f}/{max(step_ms):.4f}",
        frames_per_s=f"{frames_out / sum(step_ms) * 1e3:.2f}",
        logits=tuple(out.shape), finite=True)
    del cache, out, outs, logits
    _free(torch)
    check_prefill_logits(torch, model, params, {"embeddings": frames},
                         "audio")
    del params, model
    _free(torch)
    return counts


def phase_family(torch, device):
    """Phase 11.  qwen2-1.5b and deepseek-7b served at full width and
    depth; musicgen-medium's prefill and decode at full width and depth;
    then the shoal trainer (K = 4, bf16, ``TokenPipeline``'s first batch
    of 8 x 512, ``warmup_cosine(3e-4, 10, 100)``) of qwen2-1.5b and
    musicgen-medium at full width and depth, 5 steps, and of deepseek-7b
    at full width and 4 layers, 2 steps; every trainer held to the xla
    backend on the first batch,
    every ring result bitwise the plain ring's, the exchanges the JAX
    step's, and the ring at each trainer's largest leaf timed beside the
    plain version and the library call.  Returns ``({run: launch
    counts}, ring records)`` of each main path."""
    from repro_torch import configs
    from repro_torch.optim.schedule import warmup_cosine

    runs, rings = {}, []
    for arch in FAMILY_SERVED:
        t0 = time.perf_counter()
        runs[f"serve-{arch}"] = serve_family(torch, device, arch)
        say("dense", model=arch,
            serve_seconds=f"{time.perf_counter() - t0:.1f}")
    t0 = time.perf_counter()
    runs[f"serve-{MUSIC}"] = serve_frames(torch, device)
    say("audio", model=MUSIC,
        serve_seconds=f"{time.perf_counter() - t0:.1f}")
    for arch, layers, steps, tag in (
            ("qwen2-1.5b", None, TRAIN_STEPS, "dense"),
            ("deepseek-7b", DEEPSEEK_TRAIN_LAYERS, DEEPSEEK_TRAIN_STEPS,
             "dense"),
            (MUSIC, None, TRAIN_STEPS, "audio")):
        cfg = configs.full(arch)
        if layers is not None:
            say(tag, model=arch, cut=f"trained at {layers} of "
                f"{cfg.n_layers} layers (full width)")
            cfg = dataclasses.replace(cfg, n_layers=layers)
        t0 = time.perf_counter()
        runs[f"train-{arch}"], rec = phase_train(
            torch, device, cfg=cfg, tag=tag, steps=steps,
            exchanges_per_step=JAX_SHOAL_EXCHANGES[arch], extras=False,
            lr=warmup_cosine(*FAMILY_LR))
        rings.append(rec)
        say(tag, model=arch, train_seconds=f"{time.perf_counter() - t0:.1f}")
        _free(torch)
    return runs, rings


# ---------------------------------------------------------------------------
# phase 10: shoal-lint over the port's main paths
# ---------------------------------------------------------------------------

LINT_JACOBI_ITERS = 8       # the full-width Jacobi lint's iterations
LINT_COST_ITERS = 64        # iterations of each timed Jacobi turn
LINT_TURNS = (False, True, True, False)     # recorder off / on, in turns


def _sync(torch, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _same_result(torch, a, b, what):
    """A program's return value (a state, a tensor, or a tuple of them)
    on the card bitwise equal to the CPU run's."""
    from repro_torch.core.state import PgasState

    if isinstance(a, PgasState):
        _same_state(torch, a, b, what)
    elif isinstance(a, tuple):
        for x, y in zip(a, b, strict=True):
            _same_result(torch, x, y, what)
    else:
        x, y = a.cpu(), b
        if x.is_floating_point():
            x, y = _bits(torch, x), _bits(torch, y)
        require(torch.equal(x, y), f"{what}: the result differs between "
                "the card and the CPU")


def _findings(rep):
    return [(f.rule, f.severity, f.events, f.sites, f.waived, f.message)
            for f in rep.findings]


def phase_lint(torch, device, n=JACOBI_N, kernels=JACOBI_K,
               lint_iters=LINT_JACOBI_ITERS, cost_iters=LINT_COST_ITERS,
               jacobi_ops=None):
    """Phase 10.  shoal-lint over the port's main paths on the card.

    Every registry entry (``jacobi``, ``jacobi-steady``,
    ``actors-mailbox``, ``kv-migrate``, ``lossy-put``, ``moe-dispatch``)
    runs on the card under a recorder: no unwaived finding, its
    ``comm_budgets.toml`` bound met, and its event list, exchange count
    (by op tag too), collective calls, budget row and result bitwise
    equal to the same entry's CPU run (``moe-dispatch``'s float32 loss
    within 1e-5 relative).  Every probe (the
    R1-R4 programs and their clean twins, the waived aliasing packets)
    gives on the card the CPU's findings and the expected rules, and
    lands the CPU's bits; the 4-block waived vectored put on the Hopper
    scatter.  The Jacobi footnote-2 configuration (``n``², ``kernels``
    kernels, 9000-byte frames) linted over ``lint_iters`` iterations:
    clean, ``2 * lint_iters + 2`` exchanges.  Cost: the wall time of
    each lint, that Jacobi run's ms per iteration with the recorder off
    and on (``cost_iters`` iterations a turn, in turns), and its aten
    operations per iteration off (required equal to phase 4's
    ``jacobi_ops`` where given) and on.  Returns the phase's kernel
    launches by counter (counts reset at its start)."""
    from repro_torch.analysis import budget, registry
    from repro_torch.analysis.lint import events_json, record_run, report_of
    from repro_torch.apps.jacobi import JacobiApp
    from repro_torch.core.address_space import GlobalAddressSpace
    from repro_torch.kernels import launch_counts, reset_launch_counts

    cpu = torch.device("cpu")
    budgets = budget.load_budgets()
    reset_launch_counts()
    for name in registry.names():
        _sync(torch, device)
        run = registry.lint_entry(name, budgets, device=device)
        host = registry.lint_entry(name, budgets, device=cpu)
        rep = run.report
        require(rep.ok and host.report.ok,
                f"lint {name}:\n{rep.render()}\n{host.report.render()}")
        require(events_json(run.events) == events_json(host.events),
                f"lint {name}: the events differ between the card and the "
                "CPU")
        require((run.exchanges, run.tags, run.collectives, rep.budget)
                == (host.exchanges, host.tags, host.collectives,
                    host.report.budget),
                f"lint {name}: exchanges {run.exchanges} {run.tags}, "
                f"collectives {run.collectives} on the card, "
                f"{host.exchanges} {host.tags} {host.collectives} on the CPU")
        if name == "moe-dispatch":
            # a float32 model's loss: the card's GEMMs round otherwise
            # than the CPU's, so the loss is held to 1e-5, not bitwise
            got, want = float(run.result), float(host.result)
            require(abs(got - want) <= 1e-5 * abs(want),
                    f"lint {name}: loss {got} on the card, {want} on the CPU")
            result = f"loss {got!r}, CPU {want!r}"
        else:
            _same_result(torch, run.result, host.result, f"lint {name}")
            result = "bitwise the CPU's"
        say("lint", entry=name, clean=True, events=rep.n_events,
            exchanges=run.exchanges, ops=json.dumps(rep.budget["ops"]),
            budget=json.dumps(rep.budget["budget"]),
            card_wall_ms=f"{rep.wall_time_s * 1e3:.3f}",
            cpu_wall_ms=f"{host.report.wall_time_s * 1e3:.3f}",
            result=result)

    for probe in registry.PROBES:
        if probe.raises is not None:
            for dev in (device, cpu):
                try:
                    registry.run_probe(probe.name, dev)
                except probe.raises:
                    continue
                require(False, f"probe {probe.name}: no "
                        f"{probe.raises.__name__} on {dev}")
            say("lint", probe=probe.name, raises=probe.raises.__name__)
            continue
        before = launch_counts()
        run = registry.run_probe(probe.name, device)
        grew = {k: v - before[k] for k, v in launch_counts().items()
                if v != before[k]}
        host = registry.run_probe(probe.name, cpu)
        got = _findings(run.report)
        require(got == _findings(host.report),
                f"probe {probe.name}: findings differ between the card "
                f"and the CPU:\n{run.report.render()}")
        rules = tuple(f.rule for f in run.report.findings if not f.waived)
        waived = tuple(f.rule for f in run.report.waived)
        require((rules, waived) == (probe.expect, probe.waived),
                f"probe {probe.name}: {rules} / waived {waived}, expected "
                f"{probe.expect} / {probe.waived}")
        _same_result(torch, run.result, host.result, f"probe {probe.name}")
        if probe.name == "vectored-alias-waived-4" and device.type == "cuda":
            require(grew.get("datamover_scatter_sm90", 0) > 0,
                    f"probe {probe.name}: no Hopper scatter ({grew})")
        say("lint", probe=probe.name, findings=list(rules),
            waived=list(waived), landed="bitwise the CPU's",
            launches=json.dumps(grew))

    rng = np.random.default_rng(0)
    grid = rng.standard_normal((n, n)).astype(np.float32)
    blocks = torch.from_numpy(grid).reshape(kernels, n // kernels, n).to(
        device)
    app = JacobiApp(n=n, kernels=kernels, iters=lint_iters, device=device)
    st = GlobalAddressSpace(app.ctx).make_global_state()
    _sync(torch, device)
    t0 = time.perf_counter()
    (st, _), rec = record_run(app.run_blocks, st, blocks)
    _sync(torch, device)
    run_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rep = report_of(rec, "jacobi-footnote2")
    rules_s = time.perf_counter() - t0
    want = 2 * lint_iters + 2
    require(rep.ok, rep.render())
    require(app.ctx.exchanges == rec.exchanges == want
            and sum(rec.tags.values()) == want,
            f"jacobi lint: {app.ctx.exchanges} exchanges ({rec.tags}), "
            f"expected {want}")
    require(bool((st.credits == 0).all()) and bool((st.error == 0).all()),
            "jacobi lint: final credits/error not zero")
    say("lint", entry="jacobi-footnote2", grid=f"{n}x{n}", kernels=kernels,
        iters=lint_iters, clean=True, events=rep.n_events, exchanges=want,
        run_ms=f"{run_s * 1e3:.3f}", rules_ms=f"{rules_s * 1e3:.3f}")

    # the recorder's cost on the same configuration, in turns
    from repro_torch.analysis import record

    app = JacobiApp(n=n, kernels=kernels, iters=cost_iters, device=device)
    gas = GlobalAddressSpace(app.ctx)
    app.run_blocks(gas.make_global_state(), blocks)     # builds the tables
    turns = {False: [], True: []}
    for on in LINT_TURNS:
        st = gas.make_global_state()
        _sync(torch, device)
        t0 = time.perf_counter()
        if on:
            with record() as rec:
                app.run_blocks(st, blocks)
        else:
            app.run_blocks(st, blocks)
        _sync(torch, device)
        turns[on].append((time.perf_counter() - t0) * 1e3 / cost_iters)
        if on:
            require(len(rec.events) == 5 * cost_iters + 4,
                    f"recorded {len(rec.events)} events")
    ops_off = jacobi_ops_per_iter(torch, device, blocks)
    ops_on = jacobi_ops_per_iter(torch, device, blocks, recording=True)
    if jacobi_ops is not None:
        require(ops_off == jacobi_ops,
                f"aten operations per Jacobi iteration with the recorder off "
                f"{ops_off}, phase 4 {jacobi_ops}")
    say("lint", cost="jacobi", grid=f"{n}x{n}", iters_per_turn=cost_iters,
        turns="off,on,on,off",
        ms_per_iter_off=[f"{ms:.4f}" for ms in turns[False]],
        ms_per_iter_on=[f"{ms:.4f}" for ms in turns[True]],
        ms_per_iter_off_mean=f"{np.mean(turns[False]):.4f}",
        ms_per_iter_on_mean=f"{np.mean(turns[True]):.4f}",
        aten_ops_per_iter_off=ops_off, aten_ops_per_iter_on=ops_on,
        phase4_aten_ops_per_iter=jacobi_ops)
    return launch_counts()


# ---------------------------------------------------------------------------
# phase 12: the MoE family (dbrx-132b served at full width; the
# expert-parallel island over the kernel axis)
# ---------------------------------------------------------------------------

MOE_ARCH = "dbrx-132b"
# 4 of dbrx's 40 layers at full width: 14,269,470,720 parameters, 28.5 GB
# in bf16 (all 40 would be 131.6 B parameters, 263 GB: more than a card)
MOE_LAYERS, MOE_PARAMS = 4, 14_269_470_720
ISLAND_K, ISLAND_S = 4, 1024        # kernels x 4 experts, a 1 x 1024 prompt
ISLAND_TOL = 3e-2                   # bf16, of the largest |out|
# each dispatch: (exchanges, collective calls, ring launches) of one
# island call on K kernels, the aux's all-reduce included
_AR = 2 * (ISLAND_K - 1)
ISLAND_CALLS = {
    "psum": (_AR + _AR, {"all_reduce": 2}, 2),
    "rs": (2 * (ISLAND_K - 1) + _AR,
           {"all_gather": 1, "reduce_scatter": 1, "all_reduce": 1}, 3),
    "a2a": (2 + _AR, {"all_to_all": 2, "all_reduce": 1}, 1)}
# the dispatches each capacity factor checks: at the default 1.25 the
# psum and rs shards' capacity is moe_ffn's (same tokens), so are their
# drops; at 16 nothing drops (tests/md_checks.py:568-595's variant check)
ISLAND_CASES = ((1.25, ("psum", "rs")), (16.0, ("psum", "rs", "a2a")))


def check_island(torch, device, p_moe, dims, d, cases=ISLAND_CASES,
                 tag="moe"):
    """One full-width MoE layer's routed experts (``p_moe``, the served
    model's first MoE layer) over ``ISLAND_K`` kernels, on seeded
    ``(1, ISLAND_S, d)`` bf16 activations: each dispatch of ``cases``
    against ``moe_ffn`` at the same capacity factor on the card, within
    ``ISLAND_TOL`` of the largest |out|, the shared experts (deepseek-v2)
    added to the island's output as ``models.model._apply_block`` adds
    them (``moe_ffn`` includes them); its exchanges,
    ``ctx.collectives`` and ring launches exactly ``ISLAND_CALLS``; host
    ms (synchronised) and the device busy ms of one profiled call, of the
    island alone (the shared experts are neither timed nor counted).
    Returns ``{dispatch: launch counts}`` of the cf-1.25 calls (psum and
    rs) and the cf-16 a2a call."""
    from repro_torch.core.state import COLLECTIVE_KINDS, ShoalContext
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import moe as moe_lib

    gen = torch.Generator(device=device).manual_seed(17)
    h = torch.randn(1, ISLAND_S, d, generator=gen,
                    device=device).to(torch.bfloat16)
    runs = {}
    for cf, dispatches in cases:
        dcf = dataclasses.replace(dims, capacity_factor=cf)
        with torch.no_grad():
            want, want_aux = moe_lib.moe_ffn(p_moe, h, dcf)
        torch.cuda.synchronize()
        top = want.float().abs().max().item()
        for dispatch in dispatches:
            dd = dataclasses.replace(dcf, dispatch=dispatch)
            ctx = ShoalContext(ISLAND_K, device=device)
            mesh = moe_lib.ExpertMesh(ctx)

            def island():
                with torch.no_grad():
                    return moe_lib.moe_routed_island(p_moe, h, dd, mesh,
                                                     torch.bfloat16)

            torch.cuda.synchronize()
            reset_launch_counts()
            out, aux = island()
            torch.cuda.synchronize()
            counts = launch_counts()
            if dims.n_shared:       # dense, outside the island
                with torch.no_grad():
                    out = out + moe_lib.shared_experts(p_moe, h)
            exchanges, calls, rings = ISLAND_CALLS[dispatch]
            got_calls = {k: v for k, v in ctx.collectives.items() if v}
            require(ctx.exchanges == exchanges and got_calls == calls
                    and counts["ring_collective"] == rings
                    and set(ctx.collectives) == set(COLLECTIVE_KINDS),
                    f"island {dispatch} cf {cf}: exchanges {ctx.exchanges}, "
                    f"collectives {got_calls}, ring launches "
                    f"{counts['ring_collective']}; want {exchanges}, "
                    f"{calls}, {rings}")
            err = (out.float() - want.float()).abs().max().item()
            require(out.shape == want.shape
                    and bool(torch.isfinite(out).all())
                    and err <= ISLAND_TOL * top,
                    f"island {dispatch} cf {cf}: max|err| {err} vs moe_ffn "
                    f"> {ISLAND_TOL} * {top}")
            if cf == cases[0][0] or dispatch == "a2a":
                runs[dispatch] = counts
            del out
            host = host_ms(torch, island, reps=3, warmup=1)
            by_name, window = device_activity(torch, island)
            # late in the script the profiler has returned windows with
            # no device activity at all: say so rather than report 0
            busy = (f"{sum(us for _, us in by_name.values()) / 1e3:.4f}"
                    if by_name else "not measured")
            say(tag, check="island", dispatch=dispatch,
                capacity_factor=cf, kernels=ISLAND_K,
                experts_per_kernel=dims.n_experts // ISLAND_K,
                tokens=ISLAND_S, max_abs_out=top, max_abs_err=err,
                limit=f"{ISLAND_TOL}*max|out|", aux=float(aux),
                moe_ffn_aux=float(want_aux), exchanges=exchanges,
                collectives=json.dumps(got_calls),
                ring_launches=counts["ring_collective"],
                host_ms=f"{host:.3f}", device_busy_ms=busy,
                profiled_window_ms=f"{window * 1e3:.3f}")
        del want
    return runs


def time_island_rings(torch, device, d):
    """The ring kernel at the island's shapes (seed 9): the psum
    combine's all-reduce, 4 x
    ``ISLAND_S * d`` float32 (4 x 25.2 MB), and the rs dispatch's
    all-gather of 4 x ``ISLAND_S / 4 * d`` bf16 tokens and reduce-scatter
    of 4 x ``ISLAND_S * d`` float32, each against its library call.
    Run after phase 5, where the profiler has been reliable (phase 12
    runs last).  Returns ``{case: (schedule, measures)}``."""
    from repro_torch.kernels import gascore_dma as gd

    gen = torch.Generator(device=device).manual_seed(9)
    out = {}
    for case, schedule, shape, dtype in (
            ("moe-island-psum", gd.ALL_REDUCE, (ISLAND_K, ISLAND_S * d),
             torch.float32),
            ("moe-island-rs-gather", gd.ALL_GATHER,
             (ISLAND_K, ISLAND_S // ISLAND_K * d), torch.bfloat16),
            ("moe-island-rs-scatter", gd.REDUCE_SCATTER,
             (ISLAND_K, ISLAND_S * d), torch.float32)):
        x = torch.randn(*shape, generator=gen, device=device).to(dtype)
        _, m = time_ring(torch, x, schedule, "moe", case)
        out[case] = (schedule, m)
        del x
    _free(torch)
    return out


def phase_moe(torch, device, island_rings):
    """Phase 12.  dbrx-132b at full width and ``MOE_LAYERS`` of its 40
    layers (bf16, seed 0, the expert stacks drawn and cast leaf by leaf)
    served as phase 6 serves tinyllama-1.1b: 8 requests of 128-1024
    prompt tokens, 32 new tokens each, 4 lanes of 2048 slots, every
    prompt pass of every layer on the Hopper flash kernel (H 48, K 8,
    dh 128: 8 x 4 launches required), the MoE on one device
    (``moe_ffn``, capacity 1.25: decode's 4 tokens drop pairs); one
    prefill's logits, kernel vs plain version; the profiled prefill and
    decode window; peak memory.  Then the expert-parallel island on the
    first MoE layer (:func:`check_island`); the records of the ring at
    its shapes (``island_rings``, :func:`time_island_rings`) get the
    island's launches.  Returns ``({run: launch counts}, ring
    records)``."""
    from repro_torch import configs
    from repro_torch.kernels import gascore_dma as gd

    cfg = dataclasses.replace(configs.full(MOE_ARCH), n_layers=MOE_LAYERS)
    say("moe", model=MOE_ARCH, cut=f"served at {MOE_LAYERS} of 40 layers "
        "(full width)")
    torch.cuda.reset_peak_memory_stats(device)
    model, params = _init(torch, device, cfg, "moe")
    require(cfg.num_params(params) == MOE_PARAMS,
            f"{cfg.name}: {cfg.num_params(params)} parameters")
    prompts = serve_prompts(cfg.vocab)
    runs = {f"serve-{MOE_ARCH}": serve_requests(torch, model, params,
                                                prompts, "moe")}
    check_prefill_logits(torch, model, params,
                         prompt_batch(torch, model, prompts[0]), "moe")
    profile_serving(torch, model, params, prompts[0])
    say("moe", model=cfg.name, peak_allocated_mb=f"{torch.cuda.max_memory_allocated(device) / 2 ** 20:.0f}",
        card=card_line())
    _free(torch)
    layer0 = {k: v[0] for k, v in
              params["segments"][0]["b0_moe"]["moe"].items()}
    islands = check_island(torch, device, layer0, cfg.moe, cfg.d_model)
    runs.update({f"island-{k}": v for k, v in islands.items()})
    del model, params, layer0
    _free(torch)
    records = []
    for case, (schedule, m) in island_rings.items():
        rec = entry("ring_collective", RING_SRC, RING_TPU, m)
        dispatch = "psum" if schedule == gd.ALL_REDUCE else "rs"
        rec.update(case=case, main_path_route="simple",
                   launches=ring_launches(runs[f"island-{dispatch}"],
                                          "ring_collective"),
                   path_launches={run: ring_launches(c, "ring_collective")
                                  for run, c in runs.items()})
        records.append(rec)
    return runs, records


# ---------------------------------------------------------------------------
# phase 13: MLA (deepseek-v2-236b served at full width: the latent KV
# cache, absorbed decode, prompt passes on the Hopper flash kernel at q·k
# 192 / v 128)
# ---------------------------------------------------------------------------

MLA_ARCH = "deepseek-v2-236b"
# 4 of deepseek-v2's 60 layers at full width (1 dense, 3 MoE):
# 13,302,912,000 parameters, 26.6 GB in bf16 (all 60 would be 235.7 B
# parameters, 471 GB: more than a card)
MLA_LAYERS, MLA_PARAMS = 4, 13_302_912_000
# the prefill's flash call: B, S, H, K, q·k head dim, v head dim
MLA_FLASH = (1, 1024, 128, 128, 192, 128)
# ragged cases held to the plain version on both kernels (B, S, T,
# causal, at MLA_FLASH's heads and dims): S 1000, S 7, and causal=False
# over T 129 keys (one key into the last key tile)
MLA_RAGGED = ((1, 1000, 1000, True), (4, 7, 7, True), (1, 1024, 129, False))
MLA_ISLAND_CASES = ((1.25, ("psum",)),)     # 40 experts a kernel at K 4
MLA_PTXAS = "Li96ELi64E"    # the simple kernel's (96, 64) instantiations
SM90_MLA_PTXAS = "ILi192ELi128E"    # the Hopper kernel's (192, 128) ones


def check_flash_mla(torch, device):
    """Both flash kernels alone at deepseek-v2's prompt shape
    (``MLA_FLASH``, bfloat16, seed 29): first the ragged cases of
    ``MLA_RAGGED``, then the prompt shape, which the wrapper must route
    to the Hopper kernel, held and timed by :func:`_flash_case` in turns
    (``scaled_dot_product_attention`` takes a v head dim of its own),
    beside the simple kernel's own float32 floor.  Run right after phase
    6, where the profiler has been reliable.  Returns ``{kernel:
    record}``."""
    from repro_torch.kernels import attention as fa

    B, S, H, Kv, dqk, dv = MLA_FLASH
    gen = torch.Generator(device=device).manual_seed(29)
    for b, s, t, causal in MLA_RAGGED:
        q, k, v = _cross_inputs(torch, gen, device, b, s, H, Kv, t, dqk,
                                torch.bfloat16, dv)
        ms = _flash_case(torch, fa, q, k, v, f"MLA B{b}xS{s}xT{t}",
                         causal=causal, timed=False,
                         kernels=("sm90", "simple"))
        say("mla", check="flash-ragged", shape=f"B{b}xS{s}xH{H}xK{Kv}xT{t}"
            f"xdqk{dqk}xdv{dv}", causal=causal, tol=FLASH_TOL["bfloat16"],
            **{f"{r}_max_abs_err": m["err"] for r, m in ms.items()})
        del q, k, v
    q, k, v = _cross_inputs(torch, gen, device, B, S, H, Kv, S, dqk,
                            torch.bfloat16, dv)
    route = fa.flash_kernel_for(q, k, v)
    require(route == "sm90", f"flash at MLA's {dqk}/{dv}: routed to {route}")
    ms = _flash_case(torch, fa, q, k, v, f"q·k {dqk} / v {dv}",
                     kernels=("sm90", "simple"))
    out = {}
    for r, m in ms.items():
        bound_ms, bound_by = bound(m)
        out[r] = {"case": "deepseek-v2-prefill",
                  "shape": f"B{B}xS{S}xH{H}xK{Kv}xdqk{dqk}xdv{dv}",
                  "dtype": "bfloat16", "route": route,
                  "max_abs_err": m["err"], "ms": m["ms"],
                  "plain_ms": m["plain"], "library_ms": m["lib"],
                  "bound_ms": bound_ms, "bound_by": bound_by,
                  "turns_ms": m["turns"], "launches": 0}
        say("mla", kernel=f"flash_attention ({r})",
            tol=FLASH_TOL["bfloat16"],
            ratio_to_library=f"{m['ms'] / m['lib']:.3f}",
            bound_share=f"{bound_ms / m['ms']:.5f}",
            bytes_bound_ms=f"{m['nbytes'] / HBM_BPS * 1e3:.5f}",
            ops_bound_ms=f"{m['ops'] / BF16_FLOPS * 1e3:.5f}",
            f32_floor_ms=f"{m['ops'] / F32_FLOPS * 1e3:.5f}",
            **{key: (f"{val:.5f}" if isinstance(val, float) else val)
               for key, val in out[r].items() if key != "turns_ms"},
            turns_ms=json.dumps(m["turns"]), card=card_line())
    out["sm90"]["simple_ms"] = out["simple"]["ms"]
    del q, k, v
    _free(torch)
    return out


def check_absorbed_decode(torch, model, params, batch):
    """One prompt's prefill on a fresh cache, then one decode step through
    the absorbed route (scores in the latent space of the cache) and the
    same step on a copy of the cache through the materialized form
    (``_mla_materialized`` in ``_mla_absorbed``'s place: per-head keys
    and values over the whole ring): the logits within ``LOGIT_TOL`` of the largest |logit|, the
    identity the JAX package's absorbed form relies on.  Neither step
    launches a flash kernel."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import attention as attn

    absorbed_form = attn._mla_absorbed
    B, S = batch["tokens"].shape
    cache = model.make_cache(B, SLOTS)
    logits, _ = model.prefill(params, batch, cache)
    token = logits.argmax(-1)[:, None]
    pos = torch.full((B,), S, device=model.device)
    twin = [{key: {n: t.clone() for n, t in blk.items()}
             for key, blk in seg.items()} for seg in cache]
    torch.cuda.synchronize()
    reset_launch_counts()
    absorbed, _ = model.decode_step(params, cache, token, pos)
    attn._mla_absorbed = attn._mla_materialized
    try:
        materialized, _ = model.decode_step(params, twin, token, pos)
    finally:
        attn._mla_absorbed = absorbed_form
    torch.cuda.synchronize()
    counts = launch_counts()
    require(counts["flash_attention"] == 0,
            f"decode launched flash: {counts['flash_attention']}")
    absorbed, materialized = absorbed.float(), materialized.float()
    require(bool(torch.isfinite(absorbed).all())
            and absorbed.shape == (B, model.cfg.vocab), "decode logits")
    dtype = str(model.cfg.dtype).split(".")[-1]
    tol = LOGIT_TOL[dtype]
    top = materialized.abs().max().item()
    err = (absorbed - materialized).abs().max().item()
    require(err <= tol * top, f"absorbed vs materialized decode ({dtype}): "
            f"max|err| {err} > {tol} * {top}")
    say("mla", check="absorbed-decode", model=model.cfg.name, dtype=dtype,
        prompt_tokens=S, slots=SLOTS, max_abs_logit=top,
        absorbed_vs_materialized_err=err, limit=f"{tol}*max|logit|",
        argmax_equal=bool(absorbed.argmax() == materialized.argmax()))


def phase_mla(torch, device):
    """Phase 13.  deepseek-v2-236b at full width (d 5120, 128 heads, MLA
    with a 512-word latent and a 64-word rope key, 160 experts top-6 and
    2 shared) and ``MLA_LAYERS`` of its 60 layers (bf16, seed 0) served
    as phase 6 serves tinyllama-1.1b: 8 requests of 128-1024 prompt
    tokens, 32 new tokens each, 4 lanes of 2048 slots (the latent cache:
    576 words a token and layer), every prompt pass of every layer on the
    Hopper flash kernel at q·k 192 / v 128 (8 x 4 launches required, none
    of the simple kernel), decode in the absorbed form, the MoE on one
    device (``moe_ffn``); one prefill's logits, kernel vs plain version;
    the absorbed decode against the materialized one; the profiled
    prefill and decode window; peak memory.  Then the psum island on the
    first MoE layer, the shared experts added outside it
    (:func:`check_island`).  Returns ``{run: launch counts}``."""
    from repro_torch import configs

    cfg = dataclasses.replace(configs.full(MLA_ARCH), n_layers=MLA_LAYERS)
    say("mla", model=MLA_ARCH, cut=f"served at {MLA_LAYERS} of 60 layers "
        f"(full width; {cfg.first_k_dense} dense, "
        f"{MLA_LAYERS - cfg.first_k_dense} MoE)")
    torch.cuda.reset_peak_memory_stats(device)
    model, params = _init(torch, device, cfg, "mla")
    require(cfg.num_params(params) == MLA_PARAMS,
            f"{cfg.name}: {cfg.num_params(params)} parameters")
    prompts = serve_prompts(cfg.vocab)
    runs = {f"serve-{MLA_ARCH}": serve_requests(torch, model, params,
                                                prompts, "mla", "sm90")}
    batch = prompt_batch(torch, model, prompts[0])
    check_prefill_logits(torch, model, params, batch, "mla", "sm90")
    check_absorbed_decode(torch, model, params, batch)
    profile_serving(torch, model, params, prompts[0])
    peak_mb = torch.cuda.max_memory_allocated(device) / 2 ** 20
    say("mla", model=cfg.name, peak_allocated_mb=f"{peak_mb:.0f}",
        card=card_line())
    _free(torch)
    layer0 = {k: v[0] for k, v in
              params["segments"][1]["b0_moe"]["moe"].items()}
    islands = check_island(torch, device, layer0, cfg.moe, cfg.d_model,
                           MLA_ISLAND_CASES, "mla")
    runs.update({f"island-{MLA_ARCH}-{k}": v for k, v in islands.items()})
    del model, params, layer0
    _free(torch)
    return runs


# ---------------------------------------------------------------------------
# phase 14: cross-attention (llama-3.2-vision-90b served at full width: the
# flash kernels' causal=False branch at a key length of its own, image
# features through prefill and decode)
# ---------------------------------------------------------------------------

VLM_ARCH = "llama-3.2-vision-90b"
# 10 of the 100 layers at full width, two superblocks of 4 dense + 1 cross
# layer: 10,657,899,010 parameters, 21.3 GB in bf16 (all 100 would be
# 87.67 B parameters, 175 GB: more than a card)
VLM_LAYERS, VLM_PARAMS = 10, 10_657_899_010
VLM_B, VLM_S, VLM_DECODE = 4, 1024, 32
# cross-attention's prompt pass (B, S, H, K, T image tokens, dh) and the
# self-attention layers' (T = S, causal)
CROSS_FLASH = (4, 1024, 64, 8, 1600, 128)
# ragged non-causal shapes held to the plain version (B, S, H, K, T, dh,
# dtype): T 1000, T 129 and T 1 (the last key tile ragged: BK 128 on the
# Hopper kernel at dh 128, 32 on the simple one), S 7, and float32 on
# the simple kernel.  Left unmasked, the zero-filled keys of a last tile
# would score 0 and take a share of every row's softmax: ~1.5 % at
# T 1000, under the limit, but 12-37 % at T 129 and nearly all at T 1
CROSS_RAGGED = ((4, 1024, 64, 8, 1000, 128, "bfloat16"),
                (4, 1024, 64, 8, 129, 128, "bfloat16"),
                (4, 1024, 64, 8, 1, 128, "bfloat16"),
                (4, 7, 64, 8, 1600, 128, "bfloat16"),
                (1, 256, 64, 8, 1000, 128, "float32"))
CROSS_TOL = 3e-2            # bf16, of the largest |out| (a cross layer)


def _cross_inputs(torch, gen, device, B, S, H, Kv, T, dh, dtype, dv=None):
    """q (B, S, H, dh), k (B, T, Kv, dh), v (B, T, Kv, dv or dh)."""
    return [torch.randn(*shape, generator=gen, device=device).to(dtype)
            for shape in ((B, S, H, dh), (B, T, Kv, dh),
                          (B, T, Kv, dv or dh))]


def check_flash_cross(torch, device):
    """Both flash kernels with ``causal=False`` alone, first at
    ``CROSS_RAGGED`` and then at llama-3.2-vision's cross-attention
    prompt shape (``CROSS_FLASH``, bf16, seed 31), each against the plain
    version (bf16 3e-2, float32 2e-3, :func:`_flash_err`); at the prompt
    shape, and at the self-attention layers' causal shape (T = S = 1024,
    64 / 8 heads), timed (:func:`_flash_case`).  Run right after phase 6,
    where the profiler has been reliable.  Returns ``{(kernel, "cross" |
    "self"): record}``."""
    from repro_torch.kernels import attention as fa

    gen = torch.Generator(device=device).manual_seed(31)
    for (b, s, h, kv, t, d, name) in CROSS_RAGGED:
        dtype = getattr(torch, name)
        q, k, v = _cross_inputs(torch, gen, device, b, s, h, kv, t, d, dtype)
        ms = _flash_case(torch, fa, q, k, v, f"non-causal B{b}xS{s}xT{t}",
                         causal=False, timed=False,
                         kernels=("sm90", "simple") if name == "bfloat16"
                         else ("simple",))
        say("vlm", check="flash-noncausal", shape=f"B{b}xS{s}xH{h}xK{kv}"
            f"xT{t}xdh{d}", dtype=name, tol=FLASH_TOL[name],
            **{f"{r}_max_abs_err": m["err"] for r, m in ms.items()})
        del q, k, v
    B, S, H, Kv, T, dh = CROSS_FLASH
    out = {}
    for key, t, causal, tag in (
            ("cross", T, False, "llama-vision-cross-prefill"),
            ("self", S, True, "llama-vision-self-prefill")):
        q, k, v = _cross_inputs(torch, gen, device, B, S, H, Kv, t, dh,
                                torch.bfloat16)
        require(fa.flash_kernel_for(q, k, v) == "sm90",
                f"{tag}: bf16 at dh {dh} not routed to the Hopper kernel")
        ms = _flash_case(torch, fa, q, k, v, tag, causal=causal,
                         kernels=("sm90", "simple"))
        shape = f"B{B}xS{S}xH{H}xK{Kv}xT{t}xdh{dh}"
        for r, m in ms.items():
            bound_ms, bound_by = bound(m)
            out[r, key] = {
                "case": tag, "shape": shape, "dtype": "bfloat16",
                "causal": causal, "max_abs_err": m["err"], "ms": m["ms"],
                "plain_ms": m["plain"], "library_ms": m["lib"],
                "bound_ms": bound_ms, "bound_by": bound_by, "launches": 0}
            say("vlm", kernel=f"flash_attention ({r})", case=tag,
                shape=shape, causal=causal, tol=FLASH_TOL["bfloat16"],
                max_abs_err=m["err"], ms=f"{m['ms']:.5f}",
                plain_ms=f"{m['plain']:.5f}", library_ms=f"{m['lib']:.5f}",
                bound_ms=f"{bound_ms:.5f}", bound_by=bound_by,
                bound_share=f"{bound_ms / m['ms']:.4f}",
                ratio_to_library=f"{m['ms'] / m['lib']:.3f}",
                bytes_bound_ms=f"{m['nbytes'] / HBM_BPS * 1e3:.5f}",
                ops_bound_ms=f"{m['ops'] / BF16_FLOPS * 1e3:.5f}",
                turns_ms=json.dumps(m["turns"]))
        out["sm90", key]["simple_ms"] = out["simple", key]["ms"]
        del q, k, v
    _free(torch)
    return out


def _open_gates(torch, params, device, seed=1):
    """Every cross layer's gate drawn uniform in [0.5, 1] (seed 1):
    ``init_cross`` draws 0, and ``tanh(0)`` would zero the layer.
    Returns the gates."""
    gen = torch.Generator(device=device).manual_seed(seed)
    gates = []
    for seg in params["segments"]:
        for blk in seg.values():
            if "xattn" in blk:
                g = blk["xattn"]["gate"]
                g.copy_(torch.rand(g.shape, generator=gen, device=device)
                        * 0.5 + 0.5)
                gates += g.tolist()
    return gates


def check_vlm_prefill_logits(torch, model, params, batch):
    """The served prefill's last-token logits through the flash kernels
    against the same prefill with their plain version in their place:
    within ``LOGIT_TOL`` of the largest |logit|; the flash launches of
    each (every layer's, 2 of them non-causal; none with the plain
    version)."""
    from repro_torch.kernels import attention as fa, launch_counts
    from repro_torch.models import attention as attn

    names = ("flash_attention", "flash_attention_sm90",
             "flash_attention_noncausal")

    def prefill():
        before = launch_counts()
        logits, _ = model.prefill(params, batch,
                                  model.make_cache(VLM_B, SLOTS))
        torch.cuda.synchronize()
        after = launch_counts()
        return logits.float(), tuple(after[n] - before[n] for n in names)

    kernel, n_kernel = prefill()
    attn.flash_attention = fa.flash_attention_ref
    try:
        plain, n_plain = prefill()
    finally:
        attn.flash_attention = fa.flash_attention
    layers = model.cfg.n_layers
    cross = layers // model.cfg.cross_every
    require((n_kernel, n_plain) == ((layers, layers, cross), (0, 0, 0)),
            f"vlm logit check: (flash, sm90, non-causal) launches "
            f"{(n_kernel, n_plain)}")
    tol = LOGIT_TOL["bfloat16"]
    top = plain.abs().max().item()
    err = (kernel - plain).abs().max().item()
    require(bool(torch.isfinite(kernel).all()) and err <= tol * top,
            f"vlm prefill logits, kernel vs its plain version: max|err| "
            f"{err} > {tol} * {top}")
    say("vlm", check="prefill-logits", model=model.cfg.name,
        prompts=VLM_B, prompt_tokens=VLM_S, max_abs_logit=top,
        kernel_vs_plain_err=err, limit=f"{tol}*max|logit|",
        argmax_equal=bool((kernel.argmax(-1) == plain.argmax(-1)).all()))


def check_cross_layer(torch, model, params, feats):
    """The first cross layer (``attention.cross_attention``, its gate
    opened: the output before it times one scalar in [0.46, 0.76]) on
    seeded bf16 activations (B 4 x S 1024, seed 17) over the served
    image features: the kernel route (the Hopper kernel,
    ``causal=False``) against the same call with the plain version in
    the kernel's place, within ``CROSS_TOL`` of the largest |out|; the
    plain route ``_attend`` (``differentiable``) reported beside it."""
    from repro_torch.kernels import attention as fa, launch_counts
    from repro_torch.models import attention as attn

    cfg = model.cfg
    p = {k: v[0] for k, v in
         params["segments"][0][f"b{cfg.cross_every - 1}_cross"]["xattn"]
         .items()}
    gen = torch.Generator(device=model.device).manual_seed(17)
    h = torch.randn(VLM_B, VLM_S, cfg.d_model, generator=gen,
                    device=model.device).to(cfg.dtype)
    dims = dict(H=cfg.n_heads, K=cfg.n_kv_heads, dh=cfg.dh)
    before = launch_counts()["flash_attention_noncausal"]
    kernel = attn.cross_attention(p, h, feats, **dims).float()
    torch.cuda.synchronize()
    launched = launch_counts()["flash_attention_noncausal"] - before
    attn.flash_attention = fa.flash_attention_ref
    try:
        plain = attn.cross_attention(p, h, feats, **dims).float()
    finally:
        attn.flash_attention = fa.flash_attention
    route = attn.cross_attention(p, h, feats, differentiable=True,
                                 **dims).float()
    top = plain.abs().max().item()
    err = (kernel - plain).abs().max().item()
    require(launched == 1 and bool(torch.isfinite(kernel).all())
            and top > 0 and err <= CROSS_TOL * top,
            f"cross layer, kernel vs plain: max|err| {err} > {CROSS_TOL} * "
            f"{top}, {launched} non-causal launches")
    route_err = (kernel - route).abs().max().item()
    say("vlm", check="cross-layer", layer=f"b{cfg.cross_every - 1}_cross "
        f"(layer {cfg.cross_every - 1})", shape=tuple(kernel.shape),
        image_tokens=feats.shape[1], gate=f"{p['gate'].item():.4f}",
        max_abs_out=top, kernel_vs_plain_err=err,
        limit=f"{CROSS_TOL}*max|out|",
        kernel_vs_attend_route_err=route_err,
        attend_route_rel=f"{route_err / top:.5f}")


def profile_vlm_decode(torch, model, params, cache, token, pos, feats):
    """One 4-lane decode step re-attending the image features: the aten
    operations it dispatches, then one profiled step -- host-clock ms,
    device busy ms, idle share and the four largest device activities."""
    with count_ops_mode()() as mode:
        model.decode_step(params, cache, token, pos, image_feats=feats)
    by_name, window = device_activity(
        torch, lambda: model.decode_step(params, cache, token, pos + 1,
                                         image_feats=feats))
    busy = sum(us for _, us in by_name.values()) / 1e3
    # late in the script the profiler can return an empty window
    seen = bool(by_name)
    say("profile", vlm="decode", lanes=VLM_B, aten_ops_per_step=mode.count,
        window_ms=f"{window * 1e3:.4f}",
        device_busy_ms=f"{busy:.5f}" if seen else "not measured",
        idle_share=(f"{1 - busy / (window * 1e3):.4f}" if seen
                    else "not measured"),
        device_activities=sum(c for c, _ in by_name.values()))
    for name, (count, us) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][1])[:4]:
        say("profile", vlm="decode", device_ms=f"{us / 1e3:.5f}",
            count=count, name=name[:70].replace(" ", "_"))


def phase_vlm(torch, device):
    """Phase 14.  llama-3.2-vision-90b at full width (d 8192, 64 / 8
    heads, dh 128, d_ff 28672, vocab 128256) and ``VLM_LAYERS`` of its
    100 layers (bf16, seed 0, every cross layer's gate opened) fed 4 x
    1600 seeded image features (x 0.02, as ``TokenPipeline``) and 4 x
    1024 seeded prompt tokens: one ``Model.prefill`` on 2048 slots (every
    layer on the Hopper flash kernel: 8 causal, 2 non-causal launches
    required), then 32 decode steps with the same features (no
    flash launch); host ms of each, synchronised.  Then the prefill's
    logits and the first cross layer, kernel vs plain version; one
    profiled decode step; peak memory.  Returns ``{run: launch
    counts}``."""
    from repro_torch import configs
    from repro_torch.kernels import launch_counts, reset_launch_counts

    cfg = dataclasses.replace(configs.full(VLM_ARCH), n_layers=VLM_LAYERS)
    say("vlm", model=VLM_ARCH, cut=f"served at {VLM_LAYERS} of 100 layers "
        f"(full width; {VLM_LAYERS // cfg.cross_every} superblocks of "
        f"{cfg.cross_every - 1} dense + 1 cross)")
    torch.cuda.reset_peak_memory_stats(device)
    model, params = _init(torch, device, cfg, "vlm")
    require(cfg.num_params(params) == VLM_PARAMS,
            f"{cfg.name}: {cfg.num_params(params)} parameters")
    gates = _open_gates(torch, params, device)
    gen = torch.Generator(device=device).manual_seed(13)
    feats = torch.randn(VLM_B, cfg.n_image_tokens, cfg.d_model,
                        generator=gen, device=device) * 0.02
    tokens = torch.randint(0, cfg.vocab, (VLM_B, VLM_S), generator=gen,
                           device=device)
    batch = {"tokens": tokens, "image_feats": feats}
    say("vlm", gates=[f"{g:.4f}" for g in gates],
        image_feats=tuple(feats.shape), prompt=tuple(tokens.shape))
    # warm-up (cuBLAS, the kernels) on short prompts and two steps of
    # every lane
    cache = model.make_cache(VLM_B, SLOTS)
    logits, _ = model.prefill(params, {"tokens": tokens[:, :PROMPT_MIN],
                                       "image_feats": feats}, cache)
    for i in range(2):
        logits, _ = model.decode_step(
            params, cache, logits.argmax(-1)[:, None],
            torch.full((VLM_B,), PROMPT_MIN + i, device=device),
            image_feats=feats)
    cache = model.make_cache(VLM_B, SLOTS)
    _free(torch)
    names = ("flash_attention", "flash_attention_sm90",
             "flash_attention_noncausal")
    reset_launch_counts()
    t = time.perf_counter()
    logits, cache = model.prefill(params, batch, cache)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t) * 1e3
    after_prefill = launch_counts()
    cross = cfg.n_layers // cfg.cross_every
    got = tuple(after_prefill[n] for n in names)
    require(got == (cfg.n_layers, cfg.n_layers, cross),
            f"{cfg.name} prefill: (flash, sm90, non-causal) launches {got}, "
            f"want {(cfg.n_layers, cfg.n_layers, cross)}")
    pos = torch.full((VLM_B,), VLM_S, device=device)
    step_ms, outs, new = [], [logits], []
    for i in range(VLM_DECODE):
        token = logits.argmax(-1)[:, None]
        new.append(token)
        t = time.perf_counter()
        logits, cache = model.decode_step(params, cache, token, pos + i,
                                          image_feats=feats)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        outs.append(logits)
    counts = launch_counts()
    require(tuple(counts[n] for n in names) == got,
            f"{cfg.name} decode launched flash: "
            f"{tuple(counts[n] - after_prefill[n] for n in names)}")
    out = torch.stack(outs)
    require(out.shape == (VLM_DECODE + 1, VLM_B, cfg.vocab)
            and bool(torch.isfinite(out).all()),
            f"{cfg.name}: logits {tuple(out.shape)}, finite "
            f"{bool(torch.isfinite(out).all())}")
    tokens_out = VLM_B * VLM_DECODE
    say("vlm", main_path="ok", model=cfg.name, prompts=VLM_B,
        prompt_tokens=VLM_S, image_tokens=cfg.n_image_tokens,
        decode_steps=VLM_DECODE, slots=SLOTS, launches=counts,
        prefill_ms=f"{prefill_ms:.3f}",
        decode_ms_per_step=f"{np.mean(step_ms):.4f}",
        decode_ms_min_max=f"{min(step_ms):.4f}/{max(step_ms):.4f}",
        tokens_per_s=f"{tokens_out / sum(step_ms) * 1e3:.2f}",
        logits=tuple(out.shape), finite=True,
        first_tokens=torch.cat(new[:4], 1)[0].tolist())
    del outs, out
    profile_vlm_decode(torch, model, params, cache, new[-1],
                       pos + VLM_DECODE, feats)
    del cache
    _free(torch)
    check_vlm_prefill_logits(torch, model, params, batch)
    check_cross_layer(torch, model, params, feats)
    peak_mb = torch.cuda.max_memory_allocated(device) / 2 ** 20
    say("vlm", model=cfg.name, peak_allocated_mb=f"{peak_mb:.0f}",
        card=card_line())
    del params, model, feats, batch
    _free(torch)
    return {f"serve-{VLM_ARCH}": counts}


# ---------------------------------------------------------------------------
# phase 15: the hybrid family (recurrentgemma-2b served at full width and
# depth: RG-LRU recurrence, the sliding-window ring cache, MQA prompt passes
# through the Hopper flash kernel at head dim 256)
# ---------------------------------------------------------------------------

HYBRID_ARCH = "recurrentgemma-2b"
# 26 layers at full width: 8 superblocks of two RG-LRU blocks and one
# local-attention block, and a remainder of two RG-LRU blocks; 6.7 GB in
# bf16.  The trainer takes one superblock (3 layers: 1,544,071,680
# parameters, about 50 GB at ~32.5 bytes a trained parameter)
HYBRID_PARAMS = 3_337_459_200
HYBRID_TRAIN_LAYERS = 3
HYBRID_TRAIN_STEPS = 4
# the local layers' prompt pass: B, S, H, K, dh (MQA, head dim 256)
HYBRID_FLASH = (1, 1024, 10, 1, 256)
# ragged cases held to the plain version (B, S, H, K, T, dtype, causal):
# S 1000, S 7, and causal=False over T 129 keys (one key into the last
# key tile); bfloat16 on both kernels, float32 on the simple one
HYBRID_RAGGED = ((1, 1000, 10, 1, 1000, "bfloat16", True),
                 (4, 7, 10, 1, 7, "bfloat16", True),
                 (1, 1024, 10, 1, 129, "bfloat16", False),
                 (1, 1000, 10, 1, 1000, "float32", True))
HYBRID_PTXAS = "Li4ELi64ELi64ELi16E"    # the four-threads-a-row kernel
SM90_DH256_PTXAS = "ILi256ELi256E"      # the Hopper kernel at dh 256
# check_window_wrap: a prompt that fills all but 8 of the ring's slots,
# then decode steps through the wrap
WRAP_PROMPT, WRAP_STEPS = 2040, 32


def check_flash_hybrid(torch, device):
    """Both flash kernels alone at recurrentgemma-2b's local-attention
    prompt shape (``HYBRID_FLASH``: 10 query heads over 1 kv head at head
    dim 256, seed 37): first the ragged cases of ``HYBRID_RAGGED``, then
    the prompt shape in bf16 -- routed to the Hopper kernel, both kernels
    timed in turns -- and in float32 (the simple kernel), held to the
    plain version and timed by :func:`_flash_case` beside
    ``scaled_dot_product_attention(..., enable_gqa=True)``.  Returns
    ``{(kernel, dtype): record}``."""
    from repro_torch.kernels import attention as fa

    gen = torch.Generator(device=device).manual_seed(37)
    for (b, s, h, kv, t, name, causal) in HYBRID_RAGGED:
        q, k, v = _cross_inputs(torch, gen, device, b, s, h, kv, t, 256,
                                getattr(torch, name))
        ms = _flash_case(torch, fa, q, k, v, f"dh 256 B{b}xS{s}xT{t}",
                         causal=causal, timed=False,
                         kernels=("sm90", "simple") if name == "bfloat16"
                         else ("simple",))
        say("hybrid", check="flash-dh256", shape=f"B{b}xS{s}xH{h}xK{kv}"
            f"xT{t}xdh256", dtype=name, causal=causal, tol=FLASH_TOL[name],
            **{f"{r}_max_abs_err": m["err"] for r, m in ms.items()})
        del q, k, v
    B, S, H, Kv, dh = HYBRID_FLASH
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        q, k, v = _flash_inputs(torch, gen, device, B, S, H, Kv, dh, dtype)
        route = fa.flash_kernel_for(q, k, v)
        want = "sm90" if dtype == torch.bfloat16 else "simple"
        require(route == want, f"flash at dh {dh} ({name}): routed to "
                f"{route}, want {want}")
        ms = _flash_case(torch, fa, q, k, v, f"dh {dh} MQA",
                         kernels=tuple(dict.fromkeys((route, "simple"))))
        for r, m in ms.items():
            bound_ms, bound_by = bound(m)
            out[r, name] = {
                "case": "recurrentgemma-2b-local-prefill",
                "shape": f"B{B}xS{S}xH{H}xK{Kv}xdh{dh}", "dtype": name,
                "route": route, "max_abs_err": m["err"],
                "ms": m["ms"], "plain_ms": m["plain"], "library_ms": m["lib"],
                "bound_ms": bound_ms, "bound_by": bound_by,
                "turns_ms": m["turns"], "launches": 0}
            say("hybrid", kernel=f"flash_attention ({r})",
                tol=FLASH_TOL[name],
                ratio_to_library=f"{m['ms'] / m['lib']:.3f}",
                bound_share=f"{bound_ms / m['ms']:.5f}",
                bytes_bound_ms=f"{m['nbytes'] / HBM_BPS * 1e3:.5f}",
                ops_bound_ms=f"{m['ops'] / BF16_FLOPS * 1e3:.5f}",
                f32_floor_ms=f"{m['ops'] / F32_FLOPS * 1e3:.5f}",
                **{key: (f"{val:.5f}" if isinstance(val, float) else val)
                   for key, val in out[r, name].items()
                   if key != "turns_ms"},
                turns_ms=json.dumps(m["turns"]), card=card_line())
        del q, k, v
    out["sm90", "bfloat16"]["simple_ms"] = out["simple", "bfloat16"]["ms"]
    _free(torch)
    return out


def check_window_wrap(torch, model, params):
    """One ``WRAP_PROMPT``-token prompt prefilled on a fresh SLOTS-slot
    cache (S <= W: the kernel route, one launch a local layer), then
    ``WRAP_STEPS`` decode steps through positions ``WRAP_PROMPT`` ..
    ``WRAP_PROMPT + WRAP_STEPS - 1``: the ring wraps and the window
    masks.  The last step's logits against ``forward_train(...,
    differentiable=True)`` over the same tokens (windowed ``_attend``, no
    cache, the scan in one pass), within ``LOGIT_TOL`` of the largest
    |logit|."""
    from repro_torch.kernels import launch_counts, reset_launch_counts

    cfg = model.cfg
    n = WRAP_PROMPT + WRAP_STEPS
    gen = torch.Generator(device=model.device).manual_seed(41)
    toks = torch.randint(0, cfg.vocab, (1, n), generator=gen,
                         device=model.device)
    cache = model.make_cache(1, SLOTS)
    torch.cuda.synchronize()
    reset_launch_counts()
    t = time.perf_counter()
    logits, _ = model.prefill(params, {"tokens": toks[:, :WRAP_PROMPT]},
                              cache)
    for i in range(WRAP_PROMPT, n):
        logits, _ = model.decode_step(params, cache, toks[:, i:i + 1],
                                      torch.full((1,), i,
                                                 device=model.device))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    counts = launch_counts()
    layers = attention_layers(cfg)
    require(counts["flash_attention"] == layers
            and counts["flash_attention_sm90"] == layers,
            f"window wrap: flash launches {counts['flash_attention']} (sm90 "
            f"{counts['flash_attention_sm90']}), want {layers} on the "
            f"Hopper kernel for the one prompt pass")
    ring = cache[0]["b2_attn_local"]["pos"][0, 0]
    require(sorted(ring.tolist()) == list(range(n - SLOTS, n)),
            f"window wrap: the ring holds positions {ring.min().item()}.."
            f"{ring.max().item()}, want {n - SLOTS}..{n - 1}")
    with torch.no_grad():
        fwd, _ = model.forward_train(params, {"tokens": toks},
                                     differentiable=True)
    want = fwd[:, -1].float()
    del fwd
    got = logits.float()
    dtype = str(cfg.dtype).split(".")[-1]
    tol = LOGIT_TOL[dtype]
    top = want.abs().max().item()
    err = (got - want).abs().max().item()
    require(bool(torch.isfinite(got).all()) and err <= tol * top,
            f"window wrap ({dtype}): decode at position {n - 1} vs the "
            f"windowed forward pass: max|err| {err} > {tol} * {top}")
    say("hybrid", check="window-wrap", model=cfg.name, dtype=dtype,
        prompt_tokens=WRAP_PROMPT, decode_steps=WRAP_STEPS, slots=SLOTS,
        window=cfg.window, ring_positions=f"{n - SLOTS}..{n - 1}",
        max_abs_logit=top, decode_vs_forward_err=err,
        limit=f"{tol}*max|logit|", seconds=f"{seconds:.3f}",
        argmax_equal=bool(got.argmax() == want.argmax()))
    del cache, want, got
    _free(torch)


def phase_hybrid(torch, device):
    """Phase 15.  recurrentgemma-2b at full width (d 2560, 10 / 1 heads at
    dh 256, d_ff 7680, vocab 256000, window 2048, LRU width 2560) and
    depth (26 layers; bf16, seed 0) served as phase 6 serves
    tinyllama-1.1b: 8 requests of 128-1024 prompt tokens, 32 new tokens
    each, 4 lanes of 2048 slots; every prompt pass of each of the 8
    local-attention layers on the Hopper flash kernel at dh 256 (8 x 8
    launches required, none of the simple kernel), the RG-LRU blocks on
    the log-depth scan and, in decode, their carried float32 state.  One
    prefill's logits, kernel vs plain version; decode through the
    ring's wrap against the windowed forward pass
    (:func:`check_window_wrap`); the profiled prefill and decode window;
    peak memory.  Then the shoal trainer (K = 4, bf16, ``TokenPipeline``'s
    first batch of 8 x 512, ``warmup_cosine(3e-4, 10, 100)``) at one
    superblock (3 of 26 layers, full width): held to the xla backend on
    the first batch, every ring result bitwise the plain ring's, one ring
    launch and 6 exchanges a leaf, losses finite and falling.  Returns
    ``({run: launch counts}, the trainer's ring record)``."""
    from repro_torch import configs
    from repro_torch.optim.schedule import warmup_cosine

    cfg = configs.full(HYBRID_ARCH)
    torch.cuda.reset_peak_memory_stats(device)
    model, params = _init(torch, device, cfg, "hybrid")
    require(cfg.num_params(params) == HYBRID_PARAMS,
            f"{cfg.name}: {cfg.num_params(params)} parameters")
    say("hybrid", model=cfg.name, segments=str(cfg.segments()),
        window=cfg.window, lru_width=cfg.dr, dh=cfg.dh,
        local_layers=attention_layers(cfg))
    prompts = serve_prompts(cfg.vocab)
    runs = {f"serve-{HYBRID_ARCH}": serve_requests(
        torch, model, params, prompts, "hybrid", "sm90")}
    batch = prompt_batch(torch, model, prompts[0])
    check_prefill_logits(torch, model, params, batch, "hybrid", "sm90")
    check_window_wrap(torch, model, params)
    profile_serving(torch, model, params, prompts[0])
    peak_mb = torch.cuda.max_memory_allocated(device) / 2 ** 20
    say("hybrid", model=cfg.name, peak_allocated_mb=f"{peak_mb:.0f}",
        card=card_line())
    del model, params
    _free(torch)
    train = dataclasses.replace(cfg, n_layers=HYBRID_TRAIN_LAYERS)
    say("hybrid", model=HYBRID_ARCH, cut=f"trained at "
        f"{HYBRID_TRAIN_LAYERS} of {cfg.n_layers} layers (one superblock, "
        f"full width)")
    t0 = time.perf_counter()
    runs[f"train-{HYBRID_ARCH}"], rec = phase_train(
        torch, device, cfg=train, tag="hybrid", steps=HYBRID_TRAIN_STEPS,
        extras=False, lr=warmup_cosine(*FAMILY_LR))
    say("hybrid", model=HYBRID_ARCH,
        train_seconds=f"{time.perf_counter() - t0:.1f}")
    _free(torch)
    return runs, rec


def ring_ptxas_summary(log: str, kernel="ring_cluster_kernel_sm90") -> dict:
    """A kernel's ``ptxas -v`` log in brief (the cluster ring kernel's by
    default): how many instantiations, their registers (least-most) and
    the largest spill store and load in bytes."""
    import re

    regs, spills, entries, inside = [], [0], 0, False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            inside = kernel in line
            entries += inside
        elif inside and "registers" in line:
            regs += [int(v) for v in re.findall(r"Used (\d+) registers",
                                                line)]
        elif inside and "spill" in line:
            spills += [int(v) for v in re.findall(r"(\d+) bytes spill", line)]
    return {"instantiations": entries,
            "registers": f"{min(regs, default=0)}-{max(regs, default=0)}",
            "spill_bytes_max": max(spills)}


def ring_launches(counts, name) -> int:
    """A ring record's launches in ``counts``: the cluster kernel's own
    counter, or the wrapper's less the cluster kernel's."""
    if name == "ring_collective":
        return counts[name] - counts["ring_cluster_sm90"]
    return counts[name]


def ptxas_summary(log: str) -> dict:
    """``{"dh64": "110 registers, 0 bytes spill stores, ...", ...}`` from
    the Hopper flash kernel's ``ptxas -v`` log (one entry per (q·k, v)
    instantiation: ``dh64``, ``dh128``, ``dqk192-dv128``, ``dh256``;
    ``-noncausal`` marks the ``causal=False`` ones)."""
    import re

    out, key = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            pair = re.search(r"flash_attention_kernel_sm90ILi(\d+)ELi(\d+)E",
                             line)
            key = None
            if pair:
                dqk, dv = pair.groups()
                key = f"dh{dqk}" if dqk == dv else f"dqk{dqk}-dv{dv}"
                if "Lb0E" in line:
                    key += "-noncausal"
        elif key and "spill" in line:
            out[key] = line.strip()
        elif key and "registers" in line:
            out[key] = line.split("Used", 1)[-1].strip() + "; " \
                + out.get(key, "")
    return out


def main() -> int:
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import configs
    from repro_torch.kernels import (_build, launch_counts,
                                     reset_launch_counts)

    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    say("device", card=card, torch=torch.__version__,
        cuda=torch.version.cuda, name=torch.cuda.get_device_name(0))

    t0 = time.perf_counter()
    logs = _build.build_all()
    say("build", seconds=f"{time.perf_counter() - t0:.1f}",
        sources=",".join(logs))
    for name, log in logs.items():
        if name == "gascore_dma_sm90":      # one line per instantiation
            say("build", source=name, ptxas=ring_ptxas_summary(log))
            continue
        if name == "am_pack_sm90":
            for k in ("gather_sm90_kernel", "scatter_sm90_kernel",
                      "scatter_walk_sm90_kernel"):
                say("build", source=name, kernel=k,
                    ptxas=ring_ptxas_summary(log, k))
            continue
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)

    kernels, dmc = phase_kernels(torch, device)
    say("kernels", kernel="empty_sm90_kernel", case="launch-floor",
        floor_ms=f"{floor_ms(torch, device):.5f}")

    reset_launch_counts()
    get_service = phase_ops(torch, device)
    grew = launch_counts()
    require(grew["datamover_gather_sm90"] > 0
            and grew["datamover_scatter_sm90"] > 0,
            f"ops did not launch both Hopper DataMover kernels: {grew}")
    say("ops", launches=grew)

    counts, jacobi_ops = phase_jacobi(torch, device)
    kernels["jacobi_sweep"]["launches"] = counts["jacobi_sweep"]
    reset_launch_counts()
    t0 = time.perf_counter()
    messages = phase_messages(torch, device)
    require(messages["datamover_gather_sm90"] + messages["datamover_gather"]
            > 0 and messages["datamover_scatter_sm90"]
            + messages["datamover_scatter"] > 0,
            f"the message phase did not launch the DataMover: {messages}")
    say("messages", launches=messages,
        seconds=f"{time.perf_counter() - t0:.1f}")
    t0 = time.perf_counter()
    shapes = check_message_shapes(torch, device)
    say("kernels", message_shapes_seconds=f"{time.perf_counter() - t0:.1f}")
    rings = phase_collectives(torch, device)
    island_rings = time_island_rings(
        torch, device, configs.full(MOE_ARCH).d_model)
    next(r for r in rings if r["name"] == "ring_cluster_sm90")["ptxas"] = \
        ring_ptxas_summary(logs.get("gascore_dma_sm90", ""))
    served, model, params = phase_serving(torch, device)
    kernels.update(served)
    mla_flash = check_flash_mla(torch, device)
    mla_flash["simple"]["ptxas"] = ring_ptxas_summary(logs.get("flash", ""),
                                                      MLA_PTXAS)
    mla_flash["sm90"]["ptxas"] = ring_ptxas_summary(
        logs.get("flash_sm90", ""), SM90_MLA_PTXAS)
    kernels["flash_attention"]["deepseek_v2_mla"] = mla_flash["simple"]
    kernels["flash_attention_sm90"]["deepseek_v2_mla"] = mla_flash["sm90"]
    cross_flash = check_flash_cross(torch, device)
    kernels["flash_attention"]["llama_vision_cross"] = \
        cross_flash["simple", "cross"]
    kernels["flash_attention_sm90"]["llama_vision_cross"] = \
        cross_flash["sm90", "cross"]
    kernels["flash_attention_sm90"]["llama_vision_self"] = \
        cross_flash["sm90", "self"]
    kernels["flash_attention_sm90"]["ptxas"] = ptxas_summary(
        logs.get("flash_sm90", ""))
    hybrid_flash = check_flash_hybrid(torch, device)
    hybrid_flash["simple", "bfloat16"]["ptxas"] = ring_ptxas_summary(
        logs.get("flash", ""), HYBRID_PTXAS)
    dh256 = ring_ptxas_summary(logs.get("flash_sm90", ""), SM90_DH256_PTXAS)
    hybrid_flash["sm90", "bfloat16"]["ptxas"] = dh256
    # the O accumulator alone is 128 registers a thread at dh 256: no
    # spill is taken (an empty log: the library was built before)
    require(dh256["spill_bytes_max"] == 0,
            f"the Hopper kernel spills at dh 256: {dh256}")
    kernels["flash_attention"]["recurrentgemma_dh256"] = \
        hybrid_flash["simple", "bfloat16"]
    kernels["flash_attention"]["recurrentgemma_dh256_f32"] = \
        hybrid_flash["simple", "float32"]
    kernels["flash_attention_sm90"]["recurrentgemma_dh256"] = \
        hybrid_flash["sm90", "bfloat16"]
    t0 = time.perf_counter()
    migration = phase_disagg(torch, model, params)
    del model, params
    say("disagg", seconds=f"{time.perf_counter() - t0:.1f}")
    t0 = time.perf_counter()
    trained, train_ring = phase_train(torch, device)
    say("train", seconds=f"{time.perf_counter() - t0:.1f}")
    for rec in rings:           # the trainer's all-reduces, by kernel
        rec["path_launches"]["train"] = ring_launches(trained, rec["name"])
    rings.append(train_ring)
    t0 = time.perf_counter()
    linted = phase_lint(torch, device, jacobi_ops=jacobi_ops)
    say("lint", seconds=f"{time.perf_counter() - t0:.1f}",
        launches={k: v for k, v in linted.items() if v})
    kernels["jacobi_sweep"]["path_launches"] = {
        "jacobi": counts["jacobi_sweep"], "lint": linted["jacobi_sweep"]}
    for rec in rings:           # moe-dispatch's aux all-reduces
        rec["path_launches"]["lint"] = ring_launches(linted, rec["name"])
    t0 = time.perf_counter()
    family, family_rings = phase_family(torch, device)
    say("family", seconds=f"{time.perf_counter() - t0:.1f}",
        card=card_line())
    t0 = time.perf_counter()
    moe, moe_rings = phase_moe(torch, device, island_rings)
    say("moe", seconds=f"{time.perf_counter() - t0:.1f}", card=card_line())
    family.update(moe)
    t0 = time.perf_counter()
    mla = phase_mla(torch, device)
    say("mla", seconds=f"{time.perf_counter() - t0:.1f}", card=card_line())
    family.update(mla)
    served = mla[f"serve-{MLA_ARCH}"]
    mla_flash["sm90"]["launches"] = served["flash_attention_sm90"]
    mla_flash["simple"]["launches"] = \
        served["flash_attention"] - served["flash_attention_sm90"]
    t0 = time.perf_counter()
    vlm = phase_vlm(torch, device)
    say("vlm", seconds=f"{time.perf_counter() - t0:.1f}", card=card_line())
    family.update(vlm)
    served = vlm[f"serve-{VLM_ARCH}"]
    cross_flash["sm90", "cross"]["launches"] = \
        served["flash_attention_noncausal"]
    cross_flash["sm90", "self"]["launches"] = \
        served["flash_attention_sm90"] - served["flash_attention_noncausal"]
    cross_flash["simple", "cross"]["launches"] = \
        served["flash_attention"] - served["flash_attention_sm90"]
    t0 = time.perf_counter()
    hybrid, hybrid_ring = phase_hybrid(torch, device)
    say("hybrid", seconds=f"{time.perf_counter() - t0:.1f}",
        card=card_line())
    family.update(hybrid)
    served = hybrid[f"serve-{HYBRID_ARCH}"]
    hybrid_flash["sm90", "bfloat16"]["launches"] = \
        served["flash_attention_sm90"]
    hybrid_flash["simple", "bfloat16"]["launches"] = \
        served["flash_attention"] - served["flash_attention_sm90"]
    family_rings.append(hybrid_ring)
    for run, ran in family.items():     # each model's main path, by kernel
        for rec in rings:
            rec["path_launches"][run] = ring_launches(ran, rec["name"])
        for name in ("flash_attention", "flash_attention_sm90"):
            kernels[name]["path_launches"][run] = ran[name]
    rings.extend(family_rings + moe_rings)
    dms = dm_records(dmc, {"ops": grew, "get_service": get_service,
                           "jacobi": counts, "messages": messages,
                           "lint": linted}, shapes)
    for op in ("gather", "scatter"):       # the routed kernel ran
        name = DM_COUNTERS[op, dmc[op]["jacobi"]["route"]]
        require(any(r["name"] == name and r["path_launches"]["jacobi"] > 0
                    and r["path_launches"]["lint"] > 0 for r in dms),
                f"{name}: no Jacobi or lint launches")

    print(card, flush=True)
    print(json.dumps({"kernels": dms + list(kernels.values()) + rings
                      + migration}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
