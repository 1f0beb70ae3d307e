"""Disaggregated serving on the PyTorch port: prefill/decode kernel sets +
PGAS KV migration (the counterpart of ``examples/serve_disagg.py``).

Four kernels on one kernel axis (2 prefill + 2 decode kernels, 2 lanes
per decode kernel).  Each request is prefilled on the prefill slice;
its ring KV cache -- laid out in the global address space by
``KvSegmentSpace`` -- moves to a free decode lane as ONE
``put_long_vectored`` (the per-layer destination addresses ride in the
packet), and the admission front end shows queue backpressure and
slot-event-driven completion.  Random weights from ``--seed``.

    PYTHONPATH=src python examples/torch_serve_disagg.py              # the card
    PYTHONPATH=src python examples/torch_serve_disagg.py --device cpu
"""

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core import am
from repro_torch.core.state import resolve_device
from repro_torch.launch.mesh import ServingSlices
from repro_torch.models.model import build_model
from repro_torch.runtime import TCP
from repro_torch.serving import REJECTED, DisaggServeTier, ServeFrontend
from repro_torch.serving.disagg import _lane_words


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--full", action="store_true",
                    help="the published width and depth (default: the "
                    "reduced smoke config)")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' to run on the CPU")
    ap.add_argument("--slots", type=int, default=16)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = (configs.full if args.full else configs.reduced)(args.arch)
    model = build_model(cfg, device=device)
    params = model.init(torch.Generator(device=device).manual_seed(args.seed))
    # vectored puts do not segment: the frame holds a whole lane, its
    # in-packet address list and the header
    lane_words = _lane_words(model, args.slots)
    n_blocks = 3 * cfg.n_layers
    transport = dataclasses.replace(
        TCP, max_packet_bytes=4 * (lane_words + n_blocks + am.HDR_WORDS))
    slices = ServingSlices(n_prefill=2, n_decode=2)
    tier = DisaggServeTier(model, params, slices, lanes_per_decode=2,
                           slots=args.slots, transport=transport,
                           device=device)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "CPU")
    print(f"{cfg.name} on {where}; KV segment layout (per decode kernel):")
    print(tier.kv.describe())

    # one migration: prefill a prompt on kernel 0, move it to lane 0 of
    # the first decode kernel, count the link traversals
    rng = np.random.default_rng(args.seed)
    _, lane_cache = tier.workers[0].prefill(rng.integers(1, cfg.vocab, 4))
    before = tier.ctx.exchanges
    tier.migrate(0, slices.decode_ids[0], 0, lane_cache)
    print(f"\none KV migration ({lane_words} words in "
          f"{tier.kv.n_blocks} blocks) took "
          f"{tier.ctx.exchanges - before} exchanges (1 fused vectored "
          "packet + 1 coalesced reply)")

    fe = ServeFrontend(tier, max_queue=3)
    jobs = [fe.submit(list(rng.integers(1, cfg.vocab, size=int(n))),
                      max_new=args.max_new)
            for n in rng.integers(2, 7, size=args.requests)]
    print(f"\nsubmitted {args.requests} requests, queue bound 3: "
          f"{sum(j.status == REJECTED for j in jobs)} rejected "
          "(backpressure)")
    fe.run_until_idle()
    for job in jobs:
        if job.status == REJECTED:
            print(f"  rid {job.rid}: rejected (retry later)")
        else:
            print(f"  rid {job.rid}: {job.status} "
                  f"tokens={fe.result(job.rid)}")
    stats = fe.stats()
    print(f"\n{stats['admitted']} admitted / {stats['rejected']} rejected, "
          f"peak queue depth {stats['peak_queue_depth']}, "
          f"{tier.migrations} KV migrations, error words "
          f"{tier.state.error.tolist()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
