#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from the sources in this checkout,
holds each against its plain PyTorch version on the card, drives the
paper's microbenchmark ops on 8 kernels, then runs the paper's Jacobi
application at its footnote-2 size (4096 x 4096 grid, 8 kernels, TCP
with 9000-byte frames so every halo row is segmented, 1024 iterations)
through ``JacobiApp``, checks it against the single-grid reference and
profiles a 64-iteration window of it (device busy time, idle share).
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
JACOBI_N, JACOBI_K, JACOBI_ITERS = 4096, 8, 1024
PROFILE_ITERS = 64         # iterations in the profiled Jacobi window
MTU_WORDS = 2250           # 9000-byte frame / 4-byte words
SEG_WORDS = 4 * MTU_WORDS + 64
K = 8
RING = [(i, (i + 1) % K) for i in range(K)]


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


def device_ms(fn, reps: int = 20, warmup: int = 3, kernel=None) -> float:
    """Device time in ms per call of ``fn``, from the device time that
    ``torch.profiler`` records over ``reps`` calls.  With ``kernel``,
    ``fn`` launches that kernel once per call and the result is the mean
    over the launches the profiler saw of device kernels whose name
    holds that string (the profiler may miss one at a window's edge; it
    must see at least half); without it, every device activity of the
    calls counts, divided by ``reps``."""
    import torch

    for _ in range(warmup):
        fn()

    def calls():
        for _ in range(reps):
            fn()

    by_name, _ = device_activity(torch, calls)
    if kernel is None:
        require(by_name, "profiler recorded no device activity")
        return sum(us for _, us in by_name.values()) / 1e3 / reps
    seen = sum(c for name, (c, _) in by_name.items() if kernel in name)
    require(reps // 2 <= seen <= reps,
            f"profiler saw {seen} launches of {kernel} in {reps} calls")
    return sum(us for name, (_, us) in by_name.items()
               if kernel in name) / 1e3 / seen


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


def check_gather(torch, dm, src, addr, nwords, W, what):
    """Gather kernel vs plain version (exact), then the times of the
    kernel, the plain version and one indexing call (``src[idx]``)."""
    got = dm.datamover_gather_cuda(src, addr, nwords, W)
    want = dm.datamover_gather_ref(src, addr, nwords, W)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    require(torch.equal(got, want), f"gather {what}: max|err| {err}")
    flat, mask = _lanes(torch, addr, nwords, src.shape[1], W)
    flat_src = src.reshape(-1)
    def kernel():
        return dm.datamover_gather_cuda(src, addr, nwords, W)

    out = dict(
        err=err,
        ms=device_ms(kernel, kernel="gather_kernel"),
        call=call_ms(kernel),
        plain=device_ms(lambda: dm.datamover_gather_ref(src, addr, nwords,
                                                        W)),
        lib=device_ms(lambda: flat_src[flat]),
        # valid words read once, addr/nwords read, packet rows written
        nbytes=int(mask.sum()) * 4 + 2 * addr.numel() * 4 + got.numel() * 4)
    say("kernels", kernel="datamover_gather", case=what,
        shape=tuple(got.shape), max_abs_err=err, **_times(out))
    return out


def check_scatter(torch, dm, seg, pay, addr, nwords, handler, active, what):
    """Scatter kernel vs plain version (exact), then the times of the
    kernel, the plain version and one ``index_put_`` of the same lanes."""
    got = dm.datamover_scatter_cuda(seg.clone(), pay, addr, nwords, handler,
                                    active)
    want = dm.datamover_scatter_ref(seg.clone(), pay, addr, nwords, handler,
                                    active)
    torch.cuda.synchronize()
    err = (got.double() - want.double()).abs().max().item()
    require(torch.equal(got, want), f"scatter {what}: max|err| {err}")
    W = pay.shape[2]
    flat, mask = _lanes(torch, addr, nwords, seg.shape[1], W, active)
    vals = pay[mask]
    work = seg.clone()
    flat_seg = work.reshape(-1)
    rmw = bool(((handler > 1) & (active != 0)).any())   # add/max/min read
    def kernel():
        return dm.datamover_scatter_cuda(work, pay, addr, nwords, handler,
                                         active)

    out = dict(
        err=err,
        ms=device_ms(kernel, kernel="scatter_kernel"),
        call=call_ms(kernel),
        plain=device_ms(lambda: dm.datamover_scatter_ref(
            work, pay, addr, nwords, handler, active), reps=5),
        lib=device_ms(lambda: flat_seg.index_put_((flat,), vals)),
        # payload words read, segment words written (and read for
        # read-modify-write handlers), four (K, B) int32 tables read
        nbytes=int(mask.sum()) * 4 * (3 if rmw else 2)
        + 4 * addr.numel() * 4)
    say("kernels", kernel="datamover_scatter", case=what,
        shape=tuple(pay.shape), max_abs_err=err, **_times(out))
    return out


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

    # -- gather at the shapes of the microbenchmark puts and gets -------
    seg = randn(K, SEG_WORDS)
    starts = [0, MTU_WORDS, 2 * MTU_WORDS, 3 * MTU_WORDS]
    full = i32([[MTU_WORDS] * 4] * K)
    check_gather(torch, dm, seg, i32([starts] * K), full, MTU_WORDS,
                 "get_medium-4seg")
    check_gather(torch, dm, randn(K, 4 * MTU_WORDS), i32([starts] * K), full,
                 MTU_WORDS, "put_long-4seg")
    check_gather(torch, dm, randn(K, MTU_WORDS), i32([[0]] * K),
                 i32([[MTU_WORDS]] * K), MTU_WORDS, "put_long-1seg")
    check_gather(torch, dm, seg, i32([[SEG_WORDS - 100, -5]] * K),
                 i32([[MTU_WORDS, 50]] * K), MTU_WORDS, "ragged-edges")

    # -- scatter: disjoint and aliasing strides, every built-in handler --
    for dtype in (torch.float32, torch.int32):
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

    # -- the DataMover at the Jacobi run's shapes (JSON numbers): the up
    #    halo put, whose senders are kernels 1..7 and receivers 0..6 ----
    n, rows = JACOBI_N, JACOBI_N // JACOBI_K
    W, tail = MTU_WORDS, JACOBI_N - MTU_WORDS
    sends = [0] + [1] * (K - 1)
    gather = check_gather(torch, dm, randn(K, n), i32([[0, W]] * K),
                          i32([[W * s, tail * s] for s in sends]), W,
                          "jacobi-halo-egress")
    scatter = check_scatter(torch, dm, randn(K, 2 * n), randn(K, 2, W),
                            i32([[n, n + W]] * K), i32([[W, tail]] * K),
                            i32([[1, 1]] * K),
                            i32([[s, s] for s in sends[::-1]]),
                            "jacobi-halo-ingress")

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

    def entry(name, source, replaces, m):
        t_bytes = m["nbytes"] / HBM_BPS * 1e3
        t_ops = m.get("ops", 0) / F32_FLOPS * 1e3
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": 0, "max_abs_err": m["err"],
                "ms": m["ms"], "plain_ms": m["plain"],
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": m["lib"]}

    src = "src/repro_torch/kernels/am_pack/csrc/am_pack.cu"
    return {
        "datamover_gather": entry(
            "datamover_gather", src,
            "src/repro/kernels/am_pack/am_pack.py:41", gather),
        "datamover_scatter": entry(
            "datamover_scatter", src,
            "src/repro/kernels/am_pack/am_pack.py:58", scatter),
        "jacobi_sweep": entry(
            "jacobi_sweep", "src/repro_torch/kernels/jacobi/csrc/jacobi.cu",
            "src/repro/kernels/jacobi/jacobi.py:48", band),
    }


# ---------------------------------------------------------------------------
# phase 3: the paper's microbenchmark ops on 8 kernels
# ---------------------------------------------------------------------------

def phase_ops(torch, device):
    """put_long acked/async at 1 and 4 segments, an H_ADD put, a 4-segment
    get_medium, strided puts, barrier and waits, each against its
    closed-form result and its exchange count."""
    from repro_torch.core import handlers as hd
    from repro_torch.core import ops
    from repro_torch.core.address_space import GlobalAddressSpace
    from repro_torch.core.state import ShoalContext
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

    before = ctx.exchanges
    st, got = ops.get_medium(ctx, st, RING, src_addr=0,
                             nwords=4 * mtu_words, token=3)
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
    say("ops", segments="closed-form", credits=0, error=0, words=words)


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
        require(counts["datamover_gather"] > 0
                and counts["datamover_scatter"] > 0,
                f"DataMover launches {counts}")
    say("jacobi", grid=f"{n}x{n}", kernels=kernels, iters=iters,
        max_abs_err=err, exchanges=app.ctx.exchanges,
        ms_per_iter=f"{seconds * 1e3 / iters:.4f}", launches=counts)
    if device.type == "cuda":
        profile_jacobi(torch, device, blocks)
    return counts


def profile_jacobi(torch, device, blocks, iters=PROFILE_ITERS):
    """Where an iteration of the Jacobi run goes, on its configuration:
    the aten operations it dispatches (a count over runs of 1 and 3
    iterations, differenced), and over one profiled window of ``iters``
    iterations its host-clock ms, the device's busy ms (self device time
    of every device activity, also by name) and the device's idle share
    ``1 - busy / window`` -- busy time and window from the same run."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.apps.jacobi import JacobiApp
    from repro_torch.core.address_space import GlobalAddressSpace

    kernels, rows, n = blocks.shape

    class CountOps(TorchDispatchMode):
        count = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.count += 1
            return func(*args, **(kwargs or {}))

    def fresh(k_iters):
        app = JacobiApp(n=n, kernels=kernels, iters=k_iters, device=device)
        return app, GlobalAddressSpace(app.ctx).make_global_state()

    dispatched = []
    for k_iters in (1, 3):
        app, st = fresh(k_iters)
        with CountOps() as mode:
            app.run_blocks(st, blocks)
        dispatched.append(mode.count)
    app, st = fresh(iters)
    app.run_blocks(st, blocks)                      # builds the ctx tables
    st = GlobalAddressSpace(app.ctx).make_global_state()
    by_name, window = device_activity(
        torch, lambda: app.run_blocks(st, blocks))
    busy_us = sum(us for _, us in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    say("profile", iters=iters,
        aten_ops_per_iter=(dispatched[1] - dispatched[0]) / 2,
        window_ms_per_iter=f"{window * 1e3 / iters:.4f}",
        device_busy_ms_per_iter=f"{busy_us / 1e3 / iters:.5f}",
        idle_share=f"{1 - busy_us / 1e6 / window:.4f}",
        device_activities_per_iter=sum(c for c, _ in by_name.values())
        / iters)
    for name, (count, us) in top:
        say("profile", device_ms_per_iter=f"{us / 1e3 / iters:.5f}",
            per_iter=count / iters, name=name[:70].replace(" ", "_"))


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
    from repro_torch.kernels import _build, launch_counts

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
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)

    kernels = phase_kernels(torch, device)

    before = launch_counts()
    phase_ops(torch, device)
    after = launch_counts()
    grew = {k: after[k] - before[k] for k in after}
    require(grew["datamover_gather"] > 0 and grew["datamover_scatter"] > 0,
            f"ops did not launch both DataMover kernels: {grew}")
    say("ops", launches=grew)

    counts = phase_jacobi(torch, device)
    for name, entry in kernels.items():
        entry["launches"] = counts[name]

    print(card, flush=True)
    print(json.dumps({"kernels": list(kernels.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
