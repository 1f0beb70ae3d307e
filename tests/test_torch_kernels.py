"""Plain versions of the port's kernels against the JAX package's TPU
kernels (Pallas in interpret mode, as tests/test_kernels.py runs them)
and the JAX GAScore/app code they serve.

Tolerances: DataMover gather/scatter exact (they move and combine words
with one operation each, in the same order); Jacobi 1e-6 in float32 and
2e-2 in bfloat16 (XLA may keep bf16 sums in f32, the port rounds every
operation), as in tests/test_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, strategies as st

from repro.apps.jacobi import JacobiApp as JaxJacobiApp
from repro.core import am as jam, gascore as jgc, handlers as jhd
from repro.core.state import PgasState as JaxState, ShoalContext as JaxCtx
from repro.kernels.am_pack.am_pack import am_pack_pallas, am_unpack_pallas
from repro.kernels.jacobi import jacobi_step as jax_jacobi_step
from repro.runtime.topology import make_cpu_mesh
from repro_torch.kernels import (am_pack as dm, gascore_dma as gd,
                                 jacobi as jk, launch_counts,
                                 reset_launch_counts)
from repro_torch.kernels.attention import flash_attention

RNG = np.random.default_rng(11)


@settings(max_examples=12, deadline=None)
@given(addr=st.integers(0, 50), stride=st.integers(1, 40),
       blk=st.integers(1, 8), nblocks=st.integers(1, 6))
def test_am_pack_matches_pallas(addr, stride, blk, nblocks):
    seg = RNG.standard_normal(512).astype(np.float32)
    want = am_pack_pallas(jnp.asarray(seg), addr, stride=stride,
                          blk_words=blk, nblocks=nblocks, interpret=True)
    got = dm.am_pack(torch.from_numpy(seg), addr, stride, blk, nblocks)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@settings(max_examples=12, deadline=None)
@given(addr=st.integers(0, 50), stride=st.integers(1, 40),
       blk=st.integers(1, 8), nblocks=st.integers(1, 6))
def test_am_unpack_matches_pallas_in_order(addr, stride, blk, nblocks):
    """Strides below ``blk`` alias: the Pallas kernel's fori_loop makes
    the last block win, and so must the in-order scatter."""
    seg = RNG.standard_normal(512).astype(np.float32)
    pay = RNG.standard_normal(blk * nblocks).astype(np.float32)
    want = am_unpack_pallas(jnp.asarray(seg), jnp.asarray(pay), addr,
                            stride=stride, blk_words=blk, nblocks=nblocks,
                            interpret=True)
    got = dm.am_unpack(torch.from_numpy(seg), torch.from_numpy(pay), addr,
                       stride, blk, nblocks)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        dm.am_unpack_ref(torch.from_numpy(seg), torch.from_numpy(pay), addr,
                         stride, blk, nblocks).numpy(), np.asarray(want))


@pytest.mark.parametrize("addr,stride,blk,nblocks", [
    (50, 7, 8, 4),      # the last two blocks run past the end
    (60, 3, 8, 3),      # aliasing blocks, all past the end
    (10, -6, 4, 4),     # blocks before the start
])
def test_am_pack_unpack_slide_blocks_inside_segment(addr, stride, blk,
                                                    nblocks):
    """A block that leaves the segment slides back inside it (the TPU
    kernels' dynamic_slice / dynamic_update_slice clamp), in the kernel
    wrappers and their plain versions alike."""
    seg = RNG.standard_normal(64).astype(np.float32)
    pay = RNG.standard_normal(blk * nblocks).astype(np.float32)
    want_pack = np.asarray(am_pack_pallas(
        jnp.asarray(seg), addr, stride=stride, blk_words=blk,
        nblocks=nblocks, interpret=True))
    want_unpack = np.asarray(am_unpack_pallas(
        jnp.asarray(seg), jnp.asarray(pay), addr, stride=stride,
        blk_words=blk, nblocks=nblocks, interpret=True))
    tseg, tpay = torch.from_numpy(seg), torch.from_numpy(pay)
    for pack, unpack in ((dm.am_pack, dm.am_unpack),
                         (dm.am_pack_ref, dm.am_unpack_ref)):
        np.testing.assert_array_equal(
            pack(tseg, addr, stride, blk, nblocks).numpy(), want_pack)
        np.testing.assert_array_equal(
            unpack(tseg, tpay, addr, stride, blk, nblocks).numpy(),
            want_unpack)


def _jax_ctx(S):
    return JaxCtx(mesh=make_cpu_mesh(1, ("kernel",)), axes=("kernel",),
                  segment_words=S)


@pytest.mark.parametrize("handler", range(jhd.NUM_BUILTIN))
@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("stride", [3, 11])
def test_scatter_handlers_match_strided_ingress(handler, dtype, stride):
    """Every built-in handler through the in-order scatter, per kernel
    row, against the reference's block-sequential strided ingress; blk
    8 > stride 3 aliases, stride 11 does not.  Blocks run past the
    segment end so the drop rule is covered too."""
    S, blk, nblocks, K = 64, 8, 6, 3
    seg = (RNG.standard_normal((K, S)) * 8).astype(dtype)
    pay = (RNG.standard_normal((K, nblocks * blk)) * 8).astype(dtype)
    addr = np.array([2, 20, 40], np.int32)
    nwords = np.array([nblocks * blk, nblocks * blk - 5, 17], np.int32)
    got = dm.datamover_scatter(
        torch.from_numpy(seg.copy()),
        torch.from_numpy(pay).reshape(K, nblocks, blk),
        torch.from_numpy(addr[:, None] + stride * np.arange(nblocks)).int(),
        torch.from_numpy(np.clip(nwords[:, None] - blk * np.arange(nblocks),
                                 0, blk)).int(),
        torch.full((K, nblocks), handler, dtype=torch.int32),
        torch.ones((K, nblocks), dtype=torch.int32))
    ctx = _jax_ctx(S)
    for k in range(K):
        st = JaxState.make(S, jnp.dtype(dtype))
        st = jgc.dataclasses_replace(st, segment=jnp.asarray(seg[k]))
        hdr = jam.decode(jam.encode(
            type=jam.make_type(jam.LONG, strided=True), nwords=nwords[k],
            dst_addr=addr[k], stride=stride, blk_words=blk, nblocks=nblocks,
            handler=handler))
        want = jgc.ingress_strided_seq(ctx, st, hdr, jnp.asarray(pay[k]),
                                       blk, nblocks)
        np.testing.assert_array_equal(got[k].numpy(),
                                      np.asarray(want.segment))


def test_gather_matches_egress_batch():
    """Memory-sourced rows, including a row that runs past the segment
    end and a negative address, against the reference egress."""
    S, W, K = 96, 16, 2
    seg = RNG.standard_normal((K, S)).astype(np.float32)
    src_addr = np.array([[0, 40, 90], [-3, 16, 200]], np.int32)
    nwords = np.array([[16, 9, 16], [16, 0, 5]], np.int32)
    got = dm.datamover_gather(torch.from_numpy(seg),
                              torch.from_numpy(src_addr).clamp(0, S),
                              torch.from_numpy(nwords), W)
    ctx = _jax_ctx(S)
    for k in range(K):
        st = jgc.dataclasses_replace(JaxState.make(S),
                                     segment=jnp.asarray(seg[k]))
        rows = jam.encode_batch(3, nwords=jnp.asarray(nwords[k]),
                                src_addr=jnp.asarray(src_addr[k]))
        want = jgc.egress_batch(ctx, st, rows, None, W)
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want))


@pytest.mark.parametrize("m,n", [(16, 128), (64, 128), (40, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jacobi_full_grid_matches_pallas(m, n, dtype):
    x = RNG.standard_normal((m, n)).astype(np.float32)
    want = np.asarray(jax_jacobi_step(jnp.asarray(x, dtype), use_pallas=True),
                      np.float32)
    got = jk.jacobi_step(torch.from_numpy(x).to(getattr(torch, dtype)))
    tol = 1e-6 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("kernels,rows", [(1, 8), (4, 6), (8, 4)])
def test_jacobi_band_matches_app_stencil(kernels, rows):
    """The banded form against ``JacobiApp._stencil`` of the JAX package
    on the same padded bands (global rows ``k*rows + r``), f32 1e-6."""
    n = 32
    pad = RNG.standard_normal((kernels, rows + 2, n)).astype(np.float32)
    got = jk.jacobi_band_step(torch.from_numpy(pad)).numpy()
    app = JaxJacobiApp(n=kernels * rows, kernels=1, iters=1)
    for k in range(kernels):
        want = np.asarray(app._stencil(jnp.asarray(pad[k]), k))
        np.testing.assert_allclose(got[k], want[:, :n], rtol=1e-6, atol=1e-6)


def test_band_step_writes_into_padded_buffer():
    pad = torch.from_numpy(RNG.standard_normal((3, 6, 16)).astype(np.float32))
    out_pad = torch.full_like(pad, 7.0)
    view = jk.jacobi_band_step(pad, out_pad[:, 1:-1])
    assert view.data_ptr() == out_pad[:, 1:-1].data_ptr()
    torch.testing.assert_close(out_pad[:, 1:-1], jk.jacobi_band_ref(pad),
                               rtol=0, atol=0)
    assert bool((out_pad[:, 0] == 7).all() and (out_pad[:, -1] == 7).all())


def test_cpu_tensors_never_launch_a_kernel():
    reset_launch_counts()
    seg = torch.zeros(2, 32)
    dm.datamover_gather(seg, torch.zeros(2, 1, dtype=torch.int32),
                        torch.full((2, 1), 4, dtype=torch.int32), 8)
    dm.am_unpack(seg[0], torch.ones(8), 0, 4, 4, 2)
    jk.jacobi_run(torch.zeros(8, 8), 2)
    jk.jacobi_band_step(torch.zeros(2, 6, 8))
    gd.ring_allreduce_dma(torch.ones(3, 5))
    gd.ring_collective(torch.ones(3, 3, 5), gd.ALL_REDUCE)
    flash_attention(torch.ones(1, 4, 2, 8), torch.ones(1, 4, 1, 8),
                    torch.ones(1, 4, 1, 8))
    flash_attention(*(torch.ones(1, 4, h, 64, dtype=torch.bfloat16)
                      for h in (2, 1, 1)))
    assert launch_counts() == {"datamover_gather": 0,
                               "datamover_scatter": 0,
                               "datamover_gather_sm90": 0,
                               "datamover_scatter_sm90": 0, "jacobi_sweep": 0,
                               "ring_allreduce_dma": 0, "ring_collective": 0,
                               "ring_cluster_sm90": 0,
                               "flash_attention": 0,
                               "flash_attention_sm90": 0,
                               "flash_attention_noncausal": 0}
