"""The readings a cell's limits are set from, on the card at the cell's
own size (no benchmark run runs this):

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 \
        --as program|control|<fault> [--seconds 8]

``program``: the program as the benchmark runs it (a training cell's
checked steps; a serving cell's loop for ``--seconds`` at the cell's
load, then its drain), each check's number against the reference -- the
lower readings.  ``control``: the reference computed with fp8 matrix
products in the program's place (training: its checked steps; serving:
at each position of the program's served requests, the token fp8 puts
first) -- an upper reading.  A fault of ``perfbench/faults.py`` planted
in the program -- more upper readings.  One JSON line a seed, then the
largest (``program``, faults) or smallest (``control``) reading of each
check.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))
sys.path.insert(1, str(HERE.parent / "src"))


def _free(device) -> None:
    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def train_reading(cell, seed, device, mode):
    train = cell.driver()
    if mode == "control":
        prog = train.reference(cell, seed, device, "fp8")
    else:
        handles, prog = train.program(cell, seed, device)
        del handles
    _free(device)
    ref = train.reference(cell, seed, device)
    checks, info = train.compare(prog, ref, {})
    return info, {}


def serve_reading(cell, seed, device, mode, seconds):
    serve = cell.driver()
    loop = serve.start(cell, seed, device)
    t0, t1 = serve.window(loop, seconds)
    serve.drain(loop)
    done = serve.served(loop, t0, t1)
    seqs = [done[r] for r in serve.sample(done, seed,
                                          cell.mix["check_tokens"])]
    del loop, done
    _free(device)
    logits = serve.reference_logits(cell, seed, device, seqs)
    if mode == "control":
        tokens = [lg.argmax(-1).tolist() for lg in serve.reference_logits(
            cell, seed, device, seqs, "fp8")]
    else:
        tokens = [t for _, t in seqs]
    gaps = serve.gaps(logits, tokens)
    return serve.gap_numbers(gaps), {"served_tokens": len(gaps)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--as", dest="mode", default="program")
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import torch

    from perfbench import bench, faults

    cell = bench.load_cell(HERE.parent, args.workload)
    device = torch.device(args.device)
    if args.mode not in ("program", "control"):
        faults.plant(args.mode)
    readings = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        if cell.mix["driver"] == "train":
            vals, worst = train_reading(cell, seed, device, args.mode)
        else:
            vals, worst = serve_reading(cell, seed, device, args.mode,
                                        args.seconds)
        _free(device)
        readings.append(vals)
        print(json.dumps({"workload": args.workload, "as": args.mode,
                          "seed": seed, **vals, "worst": worst,
                          "seconds": time.perf_counter() - t}), flush=True)
    pick = min if args.mode == "control" else max
    print(json.dumps({"workload": args.workload, "as": args.mode,
                      "seeds": len(readings),
                      "summary": {k: pick(r[k] for r in readings)
                                  for k in readings[0]
                                  if isinstance(readings[0][k], float)}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
