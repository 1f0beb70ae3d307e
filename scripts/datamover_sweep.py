#!/usr/bin/env python3
"""Shape sweep of the two DataMover designs on one CUDA card.

    python3 scripts/datamover_sweep.py

For the gather and the scatter of ``kernels/am_pack`` on K = 1 and 8
kernel rows, B = 1 to 256 packet rows per kernel row (the scatter also
512 to 2048 at rows of 4 to 64 lanes), W = 4 to 2250 lanes, disjoint
and aliasing blocks (the scatter's blocks start W / 3 apart, so every
word meets about three of them), every built-in handler mixed in each
scatter call (and each handler alone on 8 x B x 64, B = 2, 40, 256);
at W = 4, 8, 64 and 2250 also ragged rows (each row W / 2 to W words
at an address 0-2 words off the row's 16-byte boundary, the vectored
put's blocks) and, for the scatter, gated duplicate rows (the second
half of the stack repeats the first half's addresses and payload, and
the active mask lets through most first copies and a few second ones:
the reliable put's dedup-gated stack); and the message layer's own
shapes (the mailbox flush, the vectored put, the reliable put and the
bench_faults put); in float32, int32 and bfloat16: launches the Hopper design
(``csrc/am_pack_sm90.cu``, the scatter staged up to ``STAGE_MAX_B``)
and the simple design (``csrc/am_pack.cu``; 32-bit words only) on the
same input, holds both bitwise to the plain version, and prints the
device time of each in two profiler windows (Hopper then simple, simple
then Hopper), as ``torch.profiler`` records it (as in
``chip_smoke.py``), with the ratio, whether the Hopper design won both
turns, and ``datamover_kernel_for``'s route: the measurement behind
``GATHER_MIN_W``, ``SCATTER_MIN_B`` and ``SCATTER_MIN_W``.  The last
lines summarise, per operation and word type, every point the Hopper
design lost.  Each (operation, word type) runs in a process of its own
(``datamover_sweep.py OP DTYPE`` runs one).  Needs a card and nvcc.
"""

from __future__ import annotations

import importlib
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(REPO, "src"), REPO]

RUNS = (("gather", "float32"), ("gather", "int32"), ("gather", "bfloat16"),
        ("scatter", "float32"), ("scatter", "int32"),
        ("scatter", "bfloat16"))
KS = (1, 8)
BS = (1, 2, 4, 8, 16, 40, 64, 128, 256)
WIDE_BS = (512, 1024, 2048)            # scatter only, W <= 64
WS = (4, 8, 16, 64, 256, 1024, 1536, 2250)
RAGGED_WS = (4, 8, 64, 2250)           # ragged rows, gated duplicates
# the message layer's shapes on 8 kernels, (op, B, W, layout): the
# 1024-send mailbox flush, the 34 x 64 vectored put (its egress is one
# 2176-word row), the 16 x 2250 reliable put (egress; its stack of 32
# rows with duplicates) and bench_faults' 4 x 4 put (stack of 8)
MESSAGE_POINTS = (("scatter", 1024, 4, "disjoint"),
                ("scatter", 34, 64, "disjoint"),
                ("scatter", 34, 64, "ragged"),
                ("gather", 1, 2176, "disjoint"),
                ("gather", 16, 2250, "disjoint"),
                ("scatter", 32, 2250, "gated-dup"),
                ("gather", 4, 4, "disjoint"),
                ("scatter", 8, 4, "gated-dup"))
WINDOWS = (("sm90", "simple"), ("simple", "sm90"))   # two turns each
NAMES = {"sm90": {"gather": "gather_sm90_kernel",
                  "scatter": "scatter_sm90_kernel"},
         "simple": {"gather": "gather_kernel", "scatter": "scatter_kernel"}}


def turn_ms(torch, cs, fns, names, order, reps=20, tries=4):
    """Device ms per launch of each kernel in ``order``, from one
    ``torch.profiler`` window that runs ``reps`` calls of each in that
    order; a window in which the profiler missed more than half of a
    kernel's launches is taken again, up to ``tries`` windows, and then
    the turn reads None.  A kernel is told apart by its device-side
    name: ``names[r]``, and no other kernel's name holds it."""
    for r in order:
        for _ in range(3):
            fns[r]()
    for _ in range(tries):
        by_name, _ = cs.device_activity(
            torch, lambda: [fns[r]() for r in order for _ in range(reps)])
        seen = {r: [(c, us) for name, (c, us) in by_name.items()
                    if names[r] in name] for r in order}
        if all(reps // 2 <= sum(c for c, _ in v) <= reps
               for v in seen.values()):
            return {r: sum(us for _, us in v) / 1e3 / sum(c for c, _ in v)
                    for r, v in seen.items()}
    return dict.fromkeys(order)


def case(torch, op, K, B, W, layout, handler, dtype, gen, dev):
    """seg, pay, addr, nwords, handler, active of one sweep point (the
    scatter's handler per block is ``handler``, or every built-in
    handler in turn when None).  Disjoint and aliasing blocks are all
    active and move W words; ragged rows move W / 2 to W words from an
    address 0-2 words off the W-word grid; gated duplicates repeat the
    first half of the stack and let through the first copies but every
    fifth and every seventh second copy."""
    stride = W if layout in ("disjoint", "ragged", "gated-dup") \
        else max(W // 3, 1)
    S = stride * (B - 1) + W + 64
    if dtype == torch.int32:
        seg = torch.randint(-1000, 1000, (K, S), generator=gen, device=dev,
                            dtype=dtype)
        pay = torch.randint(-1000, 1000, (K, B, W), generator=gen,
                            device=dev, dtype=dtype)
    else:
        seg = torch.randn(K, S, generator=gen, device=dev).to(dtype)
        pay = torch.randn(K, B, W, generator=gen, device=dev).to(dtype)
    b = torch.arange(B, device=dev, dtype=torch.int32)
    addr = (32 + stride * b).expand(K, B).contiguous()
    nwords = torch.full((K, B), W, device=dev, dtype=torch.int32)
    hid = (b + torch.arange(K, device=dev, dtype=torch.int32)[:, None]) % 5 \
        if handler is None else torch.full((K, B), handler, device=dev,
                                           dtype=torch.int32)
    active = torch.ones((K, B), device=dev, dtype=torch.int32)
    if layout == "ragged":
        addr = (addr + b % 3).contiguous()
        nwords = (W - (b * 7) % max(W // 2, 1)).expand(K, B).contiguous()
    elif layout == "gated-dup":
        half = (B + 1) // 2
        first = b % half
        addr = (32 + stride * first).expand(K, B).contiguous()
        pay = pay[:, first.long()].contiguous()
        active = torch.where(b < half, (b % 5 != 3).int(),
                             (b % 7 == 0).int()).expand(K, B).contiguous()
    return seg, pay, addr, nwords, hid.contiguous(), active


def points(op):
    """(K, B, W, layout, handler) of every sweep point of ``op``."""
    out = []
    layouts = ("disjoint",) if op == "gather" else ("disjoint", "aliasing")
    new = ("ragged",) if op == "gather" else ("ragged", "gated-dup")
    for K in KS:
        for W in WS:
            bs = BS + (WIDE_BS if op == "scatter" and W <= 64 else ())
            for B in bs:
                for layout in layouts + (new if W in RAGGED_WS else ()):
                    out.append((K, B, W, layout, None))
    if op == "scatter":
        for B in (2, 40, 256):
            for h in range(5):
                out.append((8, B, 64, "aliasing", h))
    for o, B, W, layout in MESSAGE_POINTS:
        if o == op and (8, B, W, layout, None) not in out:
            out.append((8, B, W, layout, None))
    return out


def sweep(op: str, dtype_name: str) -> None:
    import torch

    import chip_smoke as cs
    dmm = importlib.import_module("repro_torch.kernels.am_pack.am_pack")
    from repro_torch.kernels import am_pack as dm

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(9)
    dtype = getattr(torch, dtype_name)
    designs = ("sm90", "simple") if dtype in (torch.float32, torch.int32) \
        else ("sm90",)
    names = {r: NAMES[r][op] for r in designs}
    rows = []
    for K, B, W, layout, handler in points(op):
        seg, pay, addr, nwords, hid, active = case(
            torch, op, K, B, W, layout, handler, dtype, gen, dev)
        if op == "gather":
            plan = dmm.datamover_plan(op, K, B, W, dtype)
            want = dm.datamover_gather_ref(seg, addr, nwords, W)
            out = torch.empty_like(want)
            fns = {"sm90": lambda: dmm.launch_gather_sm90(
                       seg, addr, nwords, W, out, plan),
                   "simple": lambda: dmm.launch_gather(seg, addr, nwords, W,
                                                       out)}
            got = {}
            for r in designs:
                fns[r]()
                got[r] = out.clone()
        else:
            plan = dmm.datamover_plan(op, K, B, W, dtype)
            want = dm.datamover_scatter_ref(seg.clone(), pay, addr, nwords,
                                            hid, active)
            got = {r: seg.clone() for r in designs}
            work = seg.clone()          # timed calls land on a scratch copy
            fns = {"sm90": lambda: dmm.launch_scatter_sm90(
                       work, pay, addr, nwords, hid, active, plan),
                   "simple": lambda: dmm.launch_scatter(
                       work, pay, addr, nwords, hid, active)}
            dmm.launch_scatter_sm90(got["sm90"], pay, addr, nwords, hid,
                                    active, plan)
            if "simple" in got:
                dmm.launch_scatter(got["simple"], pay, addr, nwords, hid,
                                   active)
        for r, g in got.items():
            cs.require(torch.equal(g, want),
                       f"{r} {op} K={K} B={B} W={W} {layout} h={handler} "
                       f"{dtype_name}: differs from the plain version")
        del got, want
        ms = {r: [] for r in designs}
        for order in WINDOWS:
            order = tuple(r for r in order if r in designs)
            for r, t in turn_ms(torch, cs, fns, names, order).items():
                ms[r].append(t)
        row = dict(op=op, K=K, B=B, W=W, layout=layout,
                   handler="mixed" if handler is None else handler,
                   dtype=dtype_name, ctas=plan.ctas, threads=plan.threads,
                   sm90_ms=[v and round(v, 6) for v in ms["sm90"]],
                   route=dm.datamover_kernel_for(op, K, B, W, dtype))
        missed = any(v is None for t in ms.values() for v in t)
        if missed:                 # the profiler lost this point's turns
            row.update(missed=True, sm90_wins_both=None)
        elif "simple" in ms:
            row.update(simple_ms=[round(v, 6) for v in ms["simple"]],
                       ratio=round(sum(ms["sm90"]) / sum(ms["simple"]), 3),
                       sm90_wins_both=max(ms["sm90"]) < min(ms["simple"]))
        rows.append(row)
        cs.say("sweep", **{k: (json.dumps(v) if isinstance(v, list) else v)
                           for k, v in row.items()})
        del seg, pay
    if designs == ("sm90",):
        return
    timed = [r for r in rows if not r.get("missed")]
    lost = [r for r in timed if not r["sm90_wins_both"]]

    def listed(rs):
        return json.dumps([(r["K"], r["B"], r["W"], r["layout"],
                            r["handler"], r["ratio"]) for r in rs])

    cs.say("sweep-summary", op=op, dtype=dtype_name, points=len(rows),
           missed=len(rows) - len(timed), lost=len(lost),
           routed_sm90_but_lost=listed(
               [r for r in lost if r["route"] == "sm90"]),
           routed_simple_but_sm90_won=listed(
               [r for r in timed if r["sm90_wins_both"]
                and r["route"] == "simple"]),
           lost_points=listed(lost))


def main() -> int:
    import subprocess

    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("datamover_sweep: no CUDA device", file=sys.stderr)
        return 2
    if len(sys.argv) == 3:
        sweep(sys.argv[1], sys.argv[2])
        return 0
    for op, dtype in RUNS:          # a process each: a fresh profiler
        subprocess.run([sys.executable, os.path.abspath(__file__), op,
                        dtype], check=True)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
