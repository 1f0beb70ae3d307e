"""Quickstart: the Shoal PGAS API on the PyTorch port (the counterpart of
``examples/quickstart.py``).

Eight kernels on one kernel axis, then: one-sided puts, a remote
accumulate, a barrier, a get, and a ring all-reduce built from puts
(the GAScore's ring kernel on the card).

    PYTHONPATH=src python examples/torch_quickstart.py              # the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""

import argparse

import torch

from repro_torch.core import collectives, ops
from repro_torch.core import handlers as hd
from repro_torch.core.address_space import GlobalAddressSpace
from repro_torch.core.state import (ShoalContext, raise_on_error, replace,
                                    resolve_device)
from repro_torch.runtime import TCP

N = 8


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' to run on the CPU")
    args = ap.parse_args(argv)

    ctx = ShoalContext(N, TCP, segment_words=64,
                       device=resolve_device(args.device))
    gas = GlobalAddressSpace(ctx)
    ring = [(i, (i + 1) % N) for i in range(N)]
    state = gas.make_global_state()
    me = ctx.my_id().to(torch.float32)

    # 1. one-sided put: my rank + 1, 4 words, into my successor's segment
    payload = (me + 1)[:, None].expand(N, 4).contiguous()
    state = ops.put_long(ctx, state, payload, ring, dst_addr=0, token=1)
    state = ops.wait_replies(ctx, state, token=1, n=1)
    # 2. remote accumulate (Long put with the ADD handler)
    state = ops.put_long(ctx, state, torch.ones_like(payload), ring,
                         dst_addr=0, handler=hd.H_ADD, token=2)
    state = ops.wait_replies(ctx, state, token=2, n=1)
    # 3. barrier, then a one-sided get from my successor
    state = ops.barrier(ctx, state)
    state, fetched = ops.get_medium(ctx, state, ring, src_addr=0, nwords=4,
                                    token=3)
    state = ops.wait_replies(ctx, state, token=3, n=1)
    segment = state.segment.clone()
    segment[:, 8:12] = fetched
    state = replace(state, segment=segment)
    raise_on_error(state, where="quickstart")

    seg = state.segment.cpu()
    print("segment[0:4] per kernel (predecessor rank+1, +1 accumulated):")
    print(seg[:, 0:4])
    print("fetched from successor (segment[8:12]):")
    print(seg[:, 8:12])
    pred = torch.roll(torch.arange(N, dtype=torch.float32), 1)
    assert torch.equal(seg[:, 0:4], (pred + 2)[:, None].expand(N, 4))
    assert torch.equal(seg[:, 8:12], torch.roll(seg[:, 0:4], -1, 0))
    print(f"exchanges so far: {ctx.exchanges}")

    # ring all-reduce built from one-sided puts
    xs = torch.arange(N * 4, dtype=torch.float32,
                      device=ctx.device).reshape(N, 4)
    total = collectives.ring_all_reduce(ctx, xs).cpu()
    want = xs.cpu().sum(0)
    print("ring all-reduce (every kernel holds the column sums):")
    print(total[0], "== expected", want)
    assert torch.equal(total, want.expand(N, 4))
    print("quickstart OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
