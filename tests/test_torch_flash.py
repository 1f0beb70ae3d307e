"""The port's flash attention against the JAX package's.

On the CPU ``kernels.attention.flash_attention`` runs its plain version
(the CUDA kernel is held to that version on the card by
``tests/test_torch_cuda.py``).  Here it is held to the JAX package's
Pallas kernel in interpret mode at the shapes of
``tests/test_kernels.py:99-102``, with that test's tolerances (float32
2e-3, bfloat16 3e-2: the two sum in other orders and the Pallas kernel
rounds p per block), and to the GQA model's own attention ``_attend`` on
a fresh prompt.  Inputs come from numpy with a fixed seed.  The shape
rules of the CUDA wrapper's check (``flash.check_shapes``, a pure
function) are held here to the cases ``tests/test_torch_cuda.py`` runs
on the card, a key length of its own (``T != S``) among them: taken
without causality, refused with it; equal head dims up to 256 are
taken (recurrentgemma's 256 against the Pallas kernel and the windowed
``_attend`` too), 257 refused.  The non-causal function is held to
the JAX package in ``tests/test_torch_vlm.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attention import flash_attention as jax_flash
from repro.models import attention as jattn
from repro_torch.kernels import attention as fa
from repro_torch.kernels.attention import flash as fl
from repro_torch.models import attention as tattn

RNG = np.random.default_rng(11)
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-3),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _torch(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


@pytest.mark.parametrize("bh,s,dh,blk", [
    (2, 256, 64, 128), (4, 128, 128, 64), (1, 512, 64, 128),
    (2, 200, 64, 64),                       # padded path
])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_flash_matches_pallas_interpret(bh, s, dh, blk, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v = (RNG.standard_normal((bh, s, dh)).astype(np.float32)
               for _ in range(3))
    want = jax_flash(jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                     jnp.asarray(v, jdt), block_q=blk, block_k=blk)
    # (BH, S, dh) is the port's (B=BH, S, H=1, dh)
    got = fa.flash_attention(*(_torch(x, tdt)[:, :, None]
                               for x in (q, k, v)))
    assert got.dtype == tdt and got.shape == (bh, s, 1, dh)
    np.testing.assert_allclose(got[:, :, 0].float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def test_plain_flash_is_causal():
    """Changing future keys must not change earlier outputs."""
    b, s, h, dh = 1, 256, 2, 64
    q, k, v = (torch.from_numpy(RNG.standard_normal((b, s, h, dh)).astype(
        np.float32)) for _ in range(3))
    out1 = fa.flash_attention(q, k, v)
    k2, v2 = k.clone(), v.clone()
    k2[:, s // 2:] = torch.from_numpy(
        RNG.standard_normal((b, s // 2, h, dh)).astype(np.float32))
    v2[:, s // 2:] = torch.from_numpy(
        RNG.standard_normal((b, s // 2, h, dh)).astype(np.float32))
    out2 = fa.flash_attention(q, k2, v2)
    np.testing.assert_allclose(out1[:, :s // 2].numpy(),
                               out2[:, :s // 2].numpy(), rtol=1e-5)
    assert not torch.allclose(out1[:, s // 2:], out2[:, s // 2:])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,S,H,K,dh", [(2, 37, 4, 2, 16), (1, 64, 4, 1, 32),
                                        (1, 9, 4, 4, 8)])
def test_gqa_flash_matches_jax_attend_on_a_fresh_prompt(dtype, B, S, H, K,
                                                        dh):
    """Query head h reads kv head h // (H // K), as
    ``q.reshape(B, S, K, H // K, dh)`` lays the heads out."""
    jdt, tdt, tol = DTYPES[dtype]
    q = RNG.standard_normal((B, S, H, dh)).astype(np.float32)
    k, v = (RNG.standard_normal((B, S, K, dh)).astype(np.float32)
            for _ in range(2))
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    want = jattn._attend(jnp.asarray(q, jdt).reshape(B, S, K, H // K, dh),
                         jnp.asarray(k, jdt), jnp.asarray(v, jdt),
                         jnp.asarray(pos), jnp.asarray(pos))
    got = fa.flash_attention(_torch(q, tdt), _torch(k, tdt), _torch(v, tdt))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32).reshape(
                                   B, S, H, dh), rtol=tol, atol=tol)


@pytest.mark.parametrize("S,T,lo", [(3, 12, -1), (1, 12, -1), (4, 6, 0)])
def test_plain_attend_matches_jax_over_a_ring(S, T, lo):
    """The plain route over a ring cache with unwritten (-1), stale and
    future slots, float32: a few queries, one decode query, and a ring
    with every slot written."""
    B, K, G, dh = 2, 2, 2, 8
    q = RNG.standard_normal((B, S, K, G, dh)).astype(np.float32)
    k, v = (RNG.standard_normal((B, T, K, dh)).astype(np.float32)
            for _ in range(2))
    q_pos = (np.array([[7], [2]]) + np.arange(S)).astype(np.int32)
    k_pos = RNG.integers(lo, 12, (B, T)).astype(np.int32)
    k_pos[:, 0] = 0                       # every query sees a slot
    want = jattn._attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         jnp.asarray(q_pos), jnp.asarray(k_pos))
    got = tattn._attend(*(torch.from_numpy(a) for a in (q, k, v, q_pos,
                                                         k_pos)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_flash_wrapper_refuses_non_cpu_tensors_it_cannot_launch_on():
    """A tensor that is not on the CPU goes to the kernel or raises; on
    the ``meta`` device the wrapper refuses."""
    q = torch.zeros(1, 8, 2, 16, device="meta")
    kv = torch.zeros(1, 8, 1, 16, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(q, kv, kv)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_cuda(torch.zeros(1, 8, 2, 16),
                                torch.zeros(1, 8, 1, 16),
                                torch.zeros(1, 8, 1, 16))


# (B, S, H, K, dqk, dv) the kernels take: equal head dims up to 256 and
# MLA's (192, 128), at K = H and H % K == 0
TAKEN = [(1, 1024, 128, 128, 192, 128), (2, 63, 8, 2, 192, 128),
         (1, 1, 4, 1, 192, 128), (2, 40, 4, 2, 128, 128),
         (1, 8, 2, 2, 1, 1), (1, 8, 2, 1, 100, 100),
         (1, 1024, 10, 1, 256, 256), (1, 8, 2, 2, 129, 129),
         (2, 7, 4, 4, 192, 192)]
REFUSED = [((1, 8, 2, 2, 256, 128), "head dim"),    # q·k past MLA's 192
           ((1, 8, 2, 2, 128, 192), "head dim"),    # dv > dqk
           ((1, 8, 2, 2, 192, 64), "head dim"),
           ((1, 8, 2, 2, 257, 257), "head dim"),
           ((1, 8, 2, 2, 64, 32), "head dim"),
           ((1, 8, 3, 2, 192, 128), "H % K")]


def _shapes(B, S, H, K, dqk, dv):
    return (B, S, H, dqk), (B, S, K, dqk), (B, S, K, dv)


@pytest.mark.parametrize("case", TAKEN)
def test_check_shapes_takes_equal_dims_and_mla(case):
    fl.check_shapes(*_shapes(*case))


@pytest.mark.parametrize("case,match", REFUSED)
def test_check_shapes_refuses_other_head_dims(case, match):
    with pytest.raises(ValueError, match=match):
        fl.check_shapes(*_shapes(*case))


def test_check_shapes_refuses_v_that_does_not_fit_k():
    q, k, _ = _shapes(1, 8, 2, 2, 192, 128)
    with pytest.raises(ValueError, match="q must be"):
        fl.check_shapes(q, k, (1, 8, 1, 128))
    with pytest.raises(ValueError, match="q must be"):
        fl.check_shapes(q, k, (1, 8, 2))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("bh,s,blk", [(2, 128, 64), (1, 256, 128),
                                      (3, 64, 64)])
def test_plain_flash_matches_pallas_interpret_at_dh_256(bh, s, blk, dtype):
    """recurrentgemma's head dim 256: the plain version against the
    Pallas kernel in interpret mode, with the same tolerances."""
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(s + bh)
    q, k, v = (rng.standard_normal((bh, s, 256)).astype(np.float32)
               for _ in range(3))
    want = jax_flash(jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                     jnp.asarray(v, jdt), block_q=blk, block_k=blk)
    got = fa.flash_attention(*(_torch(x, tdt)[:, :, None]
                               for x in (q, k, v)))
    np.testing.assert_allclose(got[:, :, 0].float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("S", [7, 64])
def test_mqa_flash_at_dh_256_matches_jax_attend(dtype, S):
    """recurrentgemma's local-attention prompt pass: 10 query heads over
    one kv head at head dim 256, against the JAX ``_attend`` with the
    window (S <= window, so it masks nothing)."""
    jdt, tdt, tol = DTYPES[dtype]
    B, H, dh = 1, 10, 256
    q = RNG.standard_normal((B, S, H, dh)).astype(np.float32)
    k, v = (RNG.standard_normal((B, S, 1, dh)).astype(np.float32)
            for _ in range(2))
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    want = jattn._attend(jnp.asarray(q, jdt).reshape(B, S, 1, H, dh),
                         jnp.asarray(k, jdt), jnp.asarray(v, jdt),
                         jnp.asarray(pos), jnp.asarray(pos), window=64)
    got = fa.flash_attention(_torch(q, tdt), _torch(k, tdt), _torch(v, tdt))
    # on the card bf16 takes the Hopper kernel at dh 256, float32 the
    # simple one
    assert fl.flash_kernel_for(*(_torch(a, torch.bfloat16)
                                 for a in (q, k, v))) == "sm90"
    assert fl.flash_kernel_for(*(_torch(a, torch.float32)
                                 for a in (q, k, v))) == "simple"
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32).reshape(
                                   B, S, H, dh), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_mla_shapes_go_to_the_simple_kernel(dtype):
    """MLA's q·k 192 / v 128: the simple kernel takes them in float32,
    the Hopper kernel in bfloat16."""
    q, k, v = (torch.zeros(s, dtype=dtype)
               for s in _shapes(1, 64, 4, 4, 192, 128))
    assert fl.flash_kernel_for(q, k, v) == (
        "sm90" if dtype == torch.bfloat16 else "simple")


# (B, S, T, H, K, dh) of non-causal attention: S queries over T != S keys
NONCAUSAL = [(4, 1024, 1600, 64, 8, 128), (2, 7, 1000, 8, 2, 64),
             (4, 1024, 129, 64, 8, 128), (1, 33, 1, 4, 4, 16),
             (1, 1, 9, 2, 1, 192)]


def _kv_shapes(B, S, T, H, K, dh):
    dv = 128 if dh == 192 else dh
    return (B, S, H, dh), (B, T, K, dh), (B, T, K, dv)


@pytest.mark.parametrize("case", NONCAUSAL)
def test_check_shapes_takes_another_key_length_without_causality(case):
    fl.check_shapes(*_kv_shapes(*case), causal=False)


@pytest.mark.parametrize("case", NONCAUSAL)
def test_check_shapes_refuses_another_key_length_when_causal(case):
    with pytest.raises(ValueError, match="causal attention needs"):
        fl.check_shapes(*_kv_shapes(*case))
    with pytest.raises(ValueError, match="causal attention needs"):
        fl.check_shapes(*_kv_shapes(*case), causal=True)


def test_check_shapes_refuses_no_keys_and_ragged_k_v():
    with pytest.raises(ValueError, match="T must be >= 1"):
        fl.check_shapes(*_kv_shapes(1, 8, 0, 2, 2, 64), causal=False)
    q, k, _ = _kv_shapes(1, 8, 12, 2, 2, 64)
    with pytest.raises(ValueError, match="q must be"):
        fl.check_shapes(q, k, (1, 11, 2, 64), causal=False)
    with pytest.raises(ValueError, match="H % K"):
        fl.check_shapes(q, (2, 12, 2, 64), (2, 12, 2, 64), causal=False)


@pytest.mark.parametrize("BK", [32, 64, 128])
@pytest.mark.parametrize("T", [1, 129])
def test_noncausal_limit_sees_an_unmasked_ragged_key_tile(BK, T):
    """The card's non-causal checks hold a kernel within 3e-2 of the
    largest |want| at T 1 and T 129, one key into a last tile of BK
    keys (32 on the simple kernel, 64 / 128 on the Hopper one).  Left
    unmasked, the tile's zero-filled keys score 0 and take a share of
    every row's softmax: the output they give is past that limit."""
    B, S, H, K, dh = 1, 64, 4, 2, 64
    q, k, v = (_torch(RNG.standard_normal(shape), torch.float32)
               for shape in ((B, S, H, dh), (B, T, K, dh), (B, T, K, dh)))
    pad = -T % BK
    kz, vz = (torch.cat([x, x.new_zeros(B, pad, K, dh)], 1) for x in (k, v))
    want = fa.flash_attention_ref(q, k, v, causal=False)
    unmasked = fa.flash_attention_ref(q, kz, vz, causal=False)
    err = (unmasked - want).abs().max().item()
    assert err > 3e-2 * want.abs().max().item()
