"""musicgen-medium [audio]: 48L d_model=1536 24H (kv=24) d_ff=6144
vocab=2048 -- decoder-only over EnCodec tokens [arXiv:2306.05284; hf].
The EnCodec frontend is a STUB, as in the JAX package: the batch holds
precomputed frame embeddings (B, S, d); the head predicts one codebook
stream (vocab 2048).  LayerNorm + GELU MLP per the MusicGen transformer.

``remat="dots"`` (activation checkpointing) as in the JAX package."""

import torch

from repro_torch.models.model import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium", family="audio", n_layers=48, d_model=1536,
        n_heads=24, n_kv_heads=24, d_ff=6144, vocab=2048,
        norm="ln", mlp="gelu", frontend="embeddings", remat="dots")


def reduced() -> ModelConfig:
    return ModelConfig(
        name="musicgen-smoke", family="audio", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab=128,
        norm="ln", mlp="gelu", frontend="embeddings", dtype=torch.float32)
