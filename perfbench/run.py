"""Run one cell of the port's benchmark and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds the program (``src/repro_torch``)
and ``BENCHMARK.json``.  With ``--trace 0`` the line's metrics are the
cell's end-to-end metrics; with ``--trace 1`` its per-layer metrics,
read by ``perfbench/metrics/<name>.py`` from the spans, counters and the
profiled window of that run.  The last lines on standard error, and the
line's last key, ``checks``, give each number compared beside its
limit.  The exit code is not 0, and no line is printed, without the
cards the cell asks for, or when a module of JAX or of the JAX package
is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
if str(HERE.parent) not in sys.path[:1]:
    sys.path.insert(0, str(HERE.parent))


@dataclasses.dataclass
class Context:
    cell: object
    seed: int
    seconds: float
    trace: bool
    device: object
    t_start: float


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _card(torch) -> dict:
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0)}
    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
        info["power_limit"] = line[0] if line else "not read"
    except (OSError, subprocess.SubprocessError):
        info["power_limit"] = "not read"
    return info


def main(argv=None, *, device=None) -> int:
    """``device``: run there without looking for a card (the CPU tests)."""
    args = _args(argv)
    root = HERE.parent
    src = root / "src"
    if src.is_dir() and str(src) not in sys.path:
        sys.path.insert(1, str(src))

    import torch

    from perfbench import bench

    cell = bench.load_cell(root, args.workload)
    if device is None:
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if cards < cell.chips:
            print(f"perfbench: {args.workload} needs {cell.chips} CUDA "
                  f"card(s); torch sees {cards}", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        info = _card(torch)
    else:
        device = torch.device(device)
        info = {"platform": device.type, "kind": device.type}
    info["count"] = cell.chips

    ctx = Context(cell=cell, seed=args.seed, seconds=args.seconds,
                  trace=bool(args.trace), device=device, t_start=T_START)
    out = cell.driver().run(ctx)

    loaded = bench.forbidden_modules()
    if loaded:
        print(f"perfbench: modules of JAX or of the JAX package loaded: "
              f"{loaded}", file=sys.stderr)
        return 3

    if args.trace:
        metrics = {}
        for entry in cell.per_layer:
            value = cell.reader(entry["name"]).read(out["record"])
            if value is not None:
                metrics[entry["name"]] = {"value": value,
                                          "unit": entry["unit"]}
    else:
        metrics = {e["name"]: {"value": out["end_to_end"][e["name"]],
                               "unit": e["unit"]} for e in cell.end_to_end}
    device_info = {"platform": info["platform"], "kind": info["kind"],
                   "count": info["count"],
                   "memory_peak_bytes": out["memory_peak_bytes"]}
    if "power_limit" in info:
        device_info["power_limit"] = info["power_limit"]
    result = {"correct": bench.passed(out["checks"]) and out["failed"] == 0,
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device_info}
    if args.trace:
        prof = out["profile"]
        device_info["busy_s"] = prof["busy_s"]
        device_info["window_s"] = prof["window_s"]
        result["breakdown"] = {"device_ops": prof["device_ops"],
                               "idle_gaps": prof["idle_gaps"]}
    result["checks"] = out["checks"]
    print("perfbench: phases " + json.dumps(
        {k: round(v, 3) for k, v in out.get("phases", {}).items()}),
        file=sys.stderr)
    for key, val in out.get("worst", {}).items():
        print(f"perfbench: {key} {val}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
