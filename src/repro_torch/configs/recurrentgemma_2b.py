"""recurrentgemma-2b [hybrid]: 26L d_model=2560 10H (GQA kv=1) d_ff=7680
vocab=256000 -- RG-LRU + local attention, pattern 1 attn : 2 recurrent
[arXiv:2402.19427; hf].  Sub-quadratic: RG-LRU state + 2048-token
local-attention window.

``remat="dots"`` as in the JAX package.  At bf16 the 26 layers (8
superblocks of two RG-LRU blocks and one local-attention block, and a
remainder of two RG-LRU blocks) hold about 3.3 B parameters, 6.7 GB: the
card serves it and, under ``dots``, trains it at full width and
depth."""

import torch

from repro_torch.models.model import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b", family="hybrid", n_layers=26,
        d_model=2560, n_heads=10, n_kv_heads=1, d_ff=7680, vocab=256000,
        d_head=256, window=2048, lru_width=2560,
        block_pattern=("rglru", "rglru", "attn_local"),
        sub_quadratic=True, remat="dots")


def reduced() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-smoke", family="hybrid", n_layers=5,
        d_model=80, n_heads=5, n_kv_heads=1, d_ff=160, vocab=512,
        d_head=32, window=16, lru_width=80,
        block_pattern=("rglru", "rglru", "attn_local"),
        sub_quadratic=True, dtype=torch.float32)
