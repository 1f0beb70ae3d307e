"""Operation and byte counts of the benchmark's work, and the published
peaks of one NVIDIA H100 SXM (the data sheet's dense rates, without
sparsity, at the full 700 W power limit).

Everything here is arithmetic on a configuration's sizes (the ``model``
object of a ``perfbench/configs/*.json`` file) and on tensor shapes; it
reads nothing of the program.  The model FLOPs count what the
configuration's mathematics needs -- each matrix product once, causal
attention over the positions actually attended -- and never the
program's extra work: recomputation under activation checkpointing,
the zero rows a capacity pads an expert with, or masked cache slots.
The roofline arithmetic is ``chip_smoke.py``'s ``bound`` / ``flash_ops``
(each input byte read once, each output byte written once; the larger
of the bytes bound and the operations bound), copied, not imported.
"""

from __future__ import annotations

BF16_FLOPS = 989e12      # dense bf16 / fp16 tensor-core rate
TF32_FLOPS = 495e12      # dense TF32 tensor-core rate
HBM_BPS = 3.35e12        # device memory rate, bytes/s

# the peak that a step's model FLOPs are held to, by the configuration's
# dtype
PEAK_FLOPS = {"bfloat16": BF16_FLOPS, "float16": BF16_FLOPS,
              "float32": TF32_FLOPS}


def head_dim(m: dict) -> int:
    return m.get("d_head") or m["d_model"] // m["n_heads"]


def body_params(m: dict) -> int:
    """Matrix-product parameters a token passes through below the output
    head: attention's q / k / v / o projections and, per layer, the MLP
    or the router and ``top_k`` experts (the active experts only)."""
    d, H, K, dh = m["d_model"], m["n_heads"], m["n_kv_heads"], head_dim(m)
    attn = d * H * dh * 2 + d * K * dh * 2
    moe = m.get("moe")
    if moe:
        ffn = d * moe["n_experts"] + moe["top_k"] * 3 * d * moe["d_ff_expert"]
        ffn += 3 * d * moe["d_ff_expert"] * moe.get("n_shared", 0)
    else:
        ffn = 3 * d * m["d_ff"]
    return m["n_layers"] * (attn + ffn)


def head_params(m: dict) -> int:
    """The output head's product (a tied head is counted once, as the
    product it is; the embedding lookup is no product)."""
    return m["d_model"] * m["vocab"]


def attention_flops(m: dict, keys_attended: int) -> int:
    """Score and value products of ``keys_attended`` (query, key) pairs
    summed over the sequence, in every layer and head: 2 FLOPs a
    multiply-add, ``dh`` of them for q.k and ``dh`` for p.v."""
    return 4 * m["n_layers"] * m["n_heads"] * head_dim(m) * keys_attended


def causal_pairs(S: int) -> int:
    """(query, key) pairs of causal attention over S positions."""
    return S * (S + 1) // 2


def train_step_flops(m: dict, rows: int, seq: int) -> int:
    """A training step's model FLOPs: 6 a parameter a token (forward 2,
    backward 4), and causal attention's products, three times over."""
    tokens = rows * seq
    return (6 * (body_params(m) + head_params(m)) * tokens
            + 3 * attention_flops(m, rows * causal_pairs(seq)))


def prefill_flops(m: dict, S: int) -> int:
    """A prompt pass of S tokens that gives the last position's logits."""
    return (2 * body_params(m) * S + 2 * head_params(m)
            + attention_flops(m, causal_pairs(S)))


def decode_flops(m: dict, positions) -> int:
    """One decode step over the lanes at ``positions`` (each the position
    of the token fed, so it attends ``p + 1`` keys)."""
    n = len(positions)
    return (2 * (body_params(m) + head_params(m)) * n
            + attention_flops(m, sum(p + 1 for p in positions)))


def share_of_peak(flops: float, seconds: float, dtype: str) -> float:
    """``flops`` done in ``seconds`` as a percentage of the card's peak
    for ``dtype``."""
    return 100.0 * flops / (seconds * PEAK_FLOPS[dtype])


# --------------------------------------------------------------------------
# kernels
# --------------------------------------------------------------------------

def roofline_share(ops: float, rate: float, nbytes: float,
                   seconds: float) -> float:
    """The least time the card could take -- the larger of ``nbytes``
    over the memory rate and ``ops`` over ``rate`` -- as a percentage of
    the kernel's device time ``seconds``."""
    return 100.0 * max(nbytes / HBM_BPS, ops / rate) / seconds


def ring_bytes(in_bytes: int, out_bytes: int) -> int:
    """A ring launch's bytes: the stacked input read once and the output
    written once, whatever the ring moves between its kernels."""
    return in_bytes + out_bytes


def flash_cost(B: int, S: int, T: int, H: int, K: int, dqk: int, dv: int,
               causal: bool, elt: int, dtype: str):
    """``(ops, rate, bytes)`` of one flash-attention launch: ``B H S^2``
    products of q.k and p.v for causal attention (``2 B H S T``
    without), each ``dqk`` / ``dv`` long; q (B, S, H, dqk), k (B, T, K,
    dqk) and v (B, T, K, dv) read once, o (B, S, H, dv) written once."""
    pairs = B * H * (S * S if causal else 2 * S * T)
    ops = pairs * (dqk + dv)
    nbytes = elt * (B * S * H * dqk + B * T * K * (dqk + dv) + B * S * H * dv)
    return ops, PEAK_FLOPS[dtype], nbytes
