"""tinyllama-1.1b [dense]: 22L d_model=2048 32H (GQA kv=4) d_ff=5632
vocab=32000 (llama2-arch small) [arXiv:2401.02385; hf].
``remat="dots"`` as in the JAX package."""

import torch

from repro_torch.models.model import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="tinyllama-1.1b", family="dense", n_layers=22, d_model=2048,
        n_heads=32, n_kv_heads=4, d_ff=5632, vocab=32000, remat="dots")


def reduced() -> ModelConfig:
    return ModelConfig(
        name="tinyllama-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=160, vocab=512, dtype=torch.float32)
