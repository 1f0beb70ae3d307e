"""Ring attention: sequence-parallel exact attention on Shoal puts (the
port of ``repro.models.ring_attention``).

For a long prompt the sequence is sharded over the kernel axis: each of
the ``n`` kernels owns an S/n slice of q, k, v and positions, and the
K/V blocks (with their positions) rotate around the ring ``[(i, (i+1) %
n)]`` -- one exchange per tensor and hop through the op layer's
``_permute``, the port's one-sided neighbour put, so ``ctx.exchanges``
counts every hop -- while each kernel accumulates online-softmax
partials for its q slice.  Every kernel's score block is (S/n)^2, and
all n are computed at once on the card.

The kernel axis is that of the model's
:class:`~repro_torch.models.moe.ExpertMesh` (the JAX mesh's ``model``
axis); its ``data`` groups split the batch.  The block attention is
plain tensor code, as in the JAX package (no Pallas kernel there), in
the JAX package's order and types: scores in the input dtype, then
float32, then times the scale; masked scores and the running max start
at -1e30 (a block that masks a whole row gives exp(0) terms that the
next real block wipes out); ``p`` cast to v's dtype before P·V; the
output ``num / max(den, 1e-30)``.  Autograd differentiates the whole
path (``_permute``'s index copy carries the gradient back along the
ring).
"""

from __future__ import annotations

import math

import torch

from repro_torch.core import ops

NEG = -1e30


def _block_attend(q, k, v, q_pos, k_pos, scale):
    """Partial attention of a q block against one k/v block.

    q: (B,Sq,K,G,dh) k,v: (B,Sk,K,dh); returns (num (B,Sq,K,G,dh),
    denom (B,Sq,K,G), m (B,Sq,K,G)) in float32.
    """
    s = torch.einsum("bskgh,btkh->bkgst", q, k).float() * scale
    mask = (k_pos[:, None, :] >= 0) & (k_pos[:, None, :] <= q_pos[:, :, None])
    s = torch.where(mask[:, None, None], s, NEG)
    m = torch.amax(s, dim=-1)                                 # (B,K,G,Sq)
    p = torch.exp(s - m[..., None])
    denom = torch.sum(p, dim=-1)
    num = torch.einsum("bkgst,btkh->bskgh", p.to(v.dtype), v).float()
    # reorder m, denom to (B,Sq,K,G)
    return num, torch.movedim(denom, 3, 1), torch.movedim(m, 3, 1)


def ring_attention_local(ctx, q, k, v, q_pos, k_pos, *, scale: float):
    """Every kernel's body at once, over ``ctx``'s kernel axis.

    q: (n,B,Sq,K,G,dh) the kernels' slices; k,v: (n,B,Sk,K,dh);
    q_pos/k_pos: (n,B,Sq)/(n,B,Sk) absolute positions (-1 = invalid).
    n steps, each attending the current K/V block and then rotating it
    (k, v, positions: 3 exchanges) one hop, the last step's hop
    included, as the JAX package's ``lax.scan`` does.  Returns
    (n,B,Sq,K,G,dh) exact causal attention in q's dtype.
    """
    n, B, Sq, K, G, dh = q.shape
    perm = [(i, (i + 1) % n) for i in range(n)]
    qf, qp = q.flatten(0, 1), q_pos.flatten(0, 1)
    num = torch.zeros((n * B, Sq, K, G, dh), dtype=torch.float32,
                      device=q.device)
    den = torch.zeros((n * B, Sq, K, G), dtype=torch.float32, device=q.device)
    m = torch.full((n * B, Sq, K, G), NEG, dtype=torch.float32,
                   device=q.device)
    for _ in range(n):
        n_new, d_new, m_new = _block_attend(qf, k.flatten(0, 1),
                                            v.flatten(0, 1), qp,
                                            k_pos.flatten(0, 1), scale)
        m_tot = torch.maximum(m, m_new)
        a_old = torch.exp(m - m_tot)
        a_new = torch.exp(m_new - m_tot)
        num = num * a_old[..., None] + n_new * a_new[..., None]
        den = den * a_old + d_new * a_new
        m = m_tot
        # rotate the K/V block one hop around the ring (one-sided put)
        k = ops._permute(ctx, perm, k)
        v = ops._permute(ctx, perm, v)
        k_pos = ops._permute(ctx, perm, k_pos)
    out = (num / torch.clamp_min(den, 1e-30)[..., None]).to(q.dtype)
    return out.reshape(n, B, Sq, K, G, dh)


def ring_attention(mesh, q, k, v, positions, *, scale: float | None = None):
    """Global entry: q (B,S,K,G,dh), k/v (B,S,K,dh), positions (B,S);
    S sharded over the kernels of ``mesh`` (an
    :class:`~repro_torch.models.moe.ExpertMesh`), batch over its data
    groups.  Exact causal attention, (B,S,K,G,dh) in q's dtype.
    Raises ``ValueError`` where the batch or the sequence does not
    split (the JAX ``shard_map`` cannot split them either)."""
    ctx, D = mesh.ctx, mesh.data
    n = ctx.num_kernels
    B, S = q.shape[:2]
    if B % D or S % n:
        raise ValueError(f"ring attention: batch {B} x sequence {S} does "
                         f"not shard over {D} data groups x {n} kernels")
    dh = q.shape[-1]
    scale = float(scale if scale is not None else 1.0 / math.sqrt(dh))

    def shards(x):                        # (B, S, ...) -> (n, B, S/n, ...)
        x = x.reshape((B, n, S // n) + tuple(x.shape[2:]))
        return x.transpose(0, 1).contiguous()

    out = ring_attention_local(ctx, shards(q), shards(k), shards(v),
                               shards(positions), shards(positions),
                               scale=scale)
    return out.transpose(0, 1).reshape(q.shape)
