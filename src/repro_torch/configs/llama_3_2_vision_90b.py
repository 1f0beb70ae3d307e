"""llama-3.2-vision-90b [vlm]: 100L d_model=8192 64H (GQA kv=8)
d_ff=28672 vocab=128256, cross-attn image layers (every 5th)
[hf:meta-llama/Llama-3.2-11B-Vision; unverified].  The vision tower is
a STUB: the model is fed precomputed patch embeddings (B, 1600, d).

The JAX package's config also sets ``fsdp=True`` and ``remat="dots"``;
memory and sharding policies are not ported.  At bf16 the 100 layers
hold 87.67 B parameters (175 GB), more than one card: ``chip_smoke.py``
serves 10 of them (two superblocks of 4 dense + 1 cross layer) at full
width."""

import torch

from repro_torch.models.model import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-90b", family="vlm", n_layers=100,
        d_model=8192, n_heads=64, n_kv_heads=8, d_ff=28672, vocab=128256,
        cross_every=5, n_image_tokens=1600, rope_base=5e5)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="llama-vision-smoke", family="vlm", n_layers=5, d_model=96,
        n_heads=6, n_kv_heads=2, d_ff=192, vocab=512,
        cross_every=5, n_image_tokens=16, dtype=torch.float32)
