"""The port's CUDA kernels and its main path on a CUDA card (skipped
without one).  Run on a machine with an H100 and nvcc:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: DataMover exact; Jacobi float32 1e-6, bfloat16 2e-2 (the
kernel and its plain version round the same operations, so in practice
both are exact); the Jacobi app 1e-5 against the single-grid reference,
as examples/jacobi_stencil.py holds the JAX app.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels import (am_pack as dm, jacobi as jk, launch_counts,
                                 reset_launch_counts)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the card with -m cuda")
    return torch.device("cuda")


def _i32(rows, device):
    return torch.tensor(rows, dtype=torch.int32, device=device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
@pytest.mark.parametrize("stride", [5, 40])
def test_datamover_kernels_match_plain(cuda, dtype, stride):
    gen = torch.Generator().manual_seed(stride)
    K, S, B, W = 4, 1024, 24, 32
    seg = (torch.randn(K, S, generator=gen) * 8).to(dtype).to(cuda)
    pay = (torch.randn(K, B, W, generator=gen) * 8).to(dtype).to(cuda)
    addr = _i32([[b * stride - 3 + k for b in range(B)] for k in range(K)],
                cuda)
    nwords = _i32([[W - (b + k) % 4 for b in range(B)] for k in range(K)],
                  cuda)
    handler = _i32([[(b * 3 + k) % 5 for b in range(B)] for k in range(K)],
                   cuda)
    active = _i32([[int((b + k) % 5 != 1) for b in range(B)]
                   for k in range(K)], cuda)
    got = dm.datamover_scatter(seg.clone(), pay, addr, nwords, handler,
                               active)
    want = dm.datamover_scatter_ref(seg.clone(), pay, addr, nwords, handler,
                                    active)
    assert torch.equal(got, want)
    rows = dm.datamover_gather(seg, addr, nwords, W)
    assert torch.equal(rows, dm.datamover_gather_ref(seg, addr, nwords, W))


@pytest.mark.parametrize("addr,stride,blk,nblocks", [(50, 7, 8, 4),
                                                     (60, 3, 8, 3),
                                                     (10, -6, 4, 4)])
def test_am_pack_unpack_at_segment_edge(cuda, addr, stride, blk, nblocks):
    """Blocks past either end slide back inside the segment on the card
    as in the plain versions (held to the TPU kernels on the CPU)."""
    gen = torch.Generator().manual_seed(addr)
    seg = torch.randn(64, generator=gen)
    pay = torch.randn(blk * nblocks, generator=gen)
    assert torch.equal(dm.am_pack(seg.to(cuda), addr, stride, blk,
                                  nblocks).cpu(),
                       dm.am_pack_ref(seg, addr, stride, blk, nblocks))
    assert torch.equal(dm.am_unpack(seg.to(cuda), pay.to(cuda), addr, stride,
                                    blk, nblocks).cpu(),
                       dm.am_unpack_ref(seg, pay, addr, stride, blk, nblocks))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.bfloat16, 2e-2)])
def test_jacobi_kernel_matches_plain(cuda, dtype, tol):
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(300, 257, generator=gen).to(cuda, dtype)
    torch.testing.assert_close(jk.jacobi_step(x).float(),
                               jk.jacobi_step_ref(x).float(), rtol=tol,
                               atol=tol)
    pad = torch.randn(6, 34, 257, generator=gen).to(cuda, dtype)
    torch.testing.assert_close(jk.jacobi_band_step(pad).float(),
                               jk.jacobi_band_ref(pad).float(), rtol=tol,
                               atol=tol)


def test_jacobi_app_on_the_card(cuda):
    from repro_torch.apps.jacobi import JacobiApp, jacobi_reference
    from repro_torch.runtime import TCP

    grid = np.random.default_rng(0).standard_normal((256, 256)).astype(
        np.float32)
    reset_launch_counts()
    app = JacobiApp(n=256, kernels=8, iters=10, device=cuda,
                    transport=dataclasses.replace(TCP, max_packet_bytes=256))
    out = app.run(grid)
    counts = launch_counts()
    np.testing.assert_allclose(out, jacobi_reference(grid, 10, cuda),
                               rtol=0, atol=1e-5)
    assert app.ctx.exchanges == 2 * 10 + 2
    assert counts["jacobi_sweep"] == 10
    assert counts["datamover_gather"] > 0 and counts["datamover_scatter"] > 0
