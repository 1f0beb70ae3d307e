"""deepseek-7b [dense]: 30L d_model=4096 32H (kv=32, MHA) d_ff=11008
vocab=102400 (llama-arch) [arXiv:2401.02954; hf].

``remat="dots"`` (activation checkpointing) as in the JAX package."""

import torch

from repro_torch.models.model import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="deepseek-7b", family="dense", n_layers=30, d_model=4096,
        n_heads=32, n_kv_heads=32, d_ff=11008, vocab=102400, remat="dots")


def reduced() -> ModelConfig:
    return ModelConfig(
        name="deepseek-7b-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=160, vocab=512, dtype=torch.float32)
