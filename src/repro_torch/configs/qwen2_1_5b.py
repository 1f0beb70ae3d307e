"""qwen2-1.5b [dense]: 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936, QKV bias, tied embeddings [arXiv:2407.10671; hf].

``remat="dots"`` (activation checkpointing) as in the JAX package."""

import torch

from repro_torch.models.model import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen2-1.5b", family="dense", n_layers=28, d_model=1536,
        n_heads=12, n_kv_heads=2, d_ff=8960, vocab=151936,
        qkv_bias=True, tie_embeddings=True, rope_base=1e6, remat="dots")


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen2-smoke", family="dense", n_layers=2, d_model=96,
        n_heads=6, n_kv_heads=2, d_ff=256, vocab=512,
        qkv_bias=True, tie_embeddings=True, dtype=torch.float32)
