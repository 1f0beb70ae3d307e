"""The port's causal flash attention against the JAX package's.

On the CPU ``kernels.attention.flash_attention`` runs its plain version
(the CUDA kernel is held to that version on the card by
``tests/test_torch_cuda.py``).  Here it is held to the JAX package's
Pallas kernel in interpret mode at the shapes of
``tests/test_kernels.py:99-102``, with that test's tolerances (float32
2e-3, bfloat16 3e-2: the two sum in other orders and the Pallas kernel
rounds p per block), and to the GQA model's own attention ``_attend`` on
a fresh prompt.  Inputs come from numpy with a fixed seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attention import flash_attention as jax_flash
from repro.models import attention as jattn
from repro_torch.kernels import attention as fa
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
