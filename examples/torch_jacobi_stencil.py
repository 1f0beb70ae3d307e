"""The paper's Jacobi application (Sec. IV-C) on the PyTorch port (the
counterpart of ``examples/jacobi_stencil.py``).

Partitions a 512x512 grid over 1, 2, 4 and 8 kernels on one kernel axis,
runs 64 iterations with one-sided halo exchange (the Jacobi kernel and
the DataMover on the card) and checks each run against the
single-kernel oracle -- the paper's "one source file, any topology"
claim.

    PYTHONPATH=src python examples/torch_jacobi_stencil.py              # the card
    PYTHONPATH=src python examples/torch_jacobi_stencil.py --device cpu
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.apps.jacobi import JacobiApp, jacobi_reference
from repro_torch.core.state import resolve_device

N, ITERS = 512, 64
TOL = 1e-5                  # examples/jacobi_stencil.py's bound


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' to run on the CPU")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    grid = np.random.default_rng(args.seed).standard_normal(
        (N, N)).astype(np.float32)
    ref = jacobi_reference(grid.copy(), ITERS, device="cpu")
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "CPU")
    print(f"Jacobi {N}x{N}, {ITERS} iterations on {where}")
    for kernels in (1, 2, 4, 8):
        app = JacobiApp(n=N, kernels=kernels, iters=ITERS, device=device)
        t0 = time.perf_counter()
        out = app.run(grid.copy())
        dt = time.perf_counter() - t0
        err = float(np.abs(out - ref).max())
        print(f"kernels={kernels}:  {dt * 1e3:7.1f} ms   max|err|={err:.2e}"
              f"   exchanges={app.ctx.exchanges}")
        assert err < TOL, (kernels, err)
    print("jacobi example OK (same source, four topologies)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
