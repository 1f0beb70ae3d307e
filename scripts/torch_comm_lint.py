#!/usr/bin/env python
"""shoal-lint CLI of the PyTorch port: run the comm-safety rules and
the exchange budget over registered entry points (see README "Static
analysis").

Each entry runs once, eagerly, under an event recorder and is checked
against rules R1-R5 (races, credit flow, addressing, loss hygiene);
its exchange count is then held to ``comm_budgets.toml`` (rule B1).
Any unwaived finding exits non-zero.  Entries run on the CUDA card
unless ``--device cpu`` is given.

Usage::

    python scripts/torch_comm_lint.py                   # all entries
    python scripts/torch_comm_lint.py --entry jacobi --entry kv-migrate
    python scripts/torch_comm_lint.py --list
    python scripts/torch_comm_lint.py --device cpu --json out.json
"""

import argparse
import json
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--entry", action="append", default=None,
                    help="entry point to lint (repeatable; default: all)")
    ap.add_argument("--list", action="store_true",
                    help="list registered entry points and exit")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="also write a machine-readable report to PATH")
    ap.add_argument("--budgets", metavar="TOML", default=None,
                    help="budget file (default: repo comm_budgets.toml)")
    ap.add_argument("--no-budget", action="store_true",
                    help="skip the exchange budget (rules only)")
    ap.add_argument("--device", default=None,
                    help="device to run the entries on (default: the CUDA "
                         "card; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)

    sys.path.insert(0, os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

    from repro_torch.analysis import budget, registry

    if args.list:
        for e in registry.ENTRIES:
            print(f"{e.name:16s} {e.description}")
        return 0

    names = args.entry or registry.names()
    budgets = None if args.no_budget else budget.load_budgets(args.budgets)

    t0 = time.perf_counter()
    doc = {"entries": {}, "total_wall_time_s": 0.0}
    failed = False
    for name in names:
        rep = registry.run_entry(name, budgets=budgets,
                                 include_budget=not args.no_budget,
                                 device=args.device)
        print(rep.render())
        failed = failed or not rep.ok
        doc["entries"][name] = {
            "ok": rep.ok,
            "n_events": rep.n_events,
            "tags_recovered": rep.tags_recovered,
            "wall_time_s": round(rep.wall_time_s, 3),
            "findings": [f.render() for f in rep.findings],
            "budget": rep.budget,
        }
    doc["total_wall_time_s"] = round(time.perf_counter() - t0, 3)

    if args.json:
        with open(args.json, "w") as f:
            json.dump(doc, f, indent=2, sort_keys=True)
        print(f"wrote {args.json}")

    print(f"shoal-lint: {len(names)} entr{'y' if len(names) == 1 else 'ies'} "
          f"in {doc['total_wall_time_s']:.1f}s: "
          f"{'FINDINGS' if failed else 'clean'}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
