"""dbrx-132b [moe]: 40L d_model=6144 48H (GQA kv=8) d_ff=10752
vocab=100352, 16 experts top-4, fine-grained
[hf:databricks/dbrx-base; unverified].

``remat="dots"`` as in the JAX package; its ``fsdp=True`` (a sharding
policy) is not ported.  At bf16 the 40 layers hold 131.6 B parameters
(263 GB), more than one card: ``chip_smoke.py`` serves 4 of them at full
width."""

import torch

from repro_torch.models.model import ModelConfig
from repro_torch.models.moe import MoEDims


def full() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b", family="moe", n_layers=40, d_model=6144,
        n_heads=48, n_kv_heads=8, d_ff=10752, vocab=100352,
        moe=MoEDims(n_experts=16, top_k=4, d_ff_expert=10752),
        remat="dots")


def reduced() -> ModelConfig:
    return ModelConfig(
        name="dbrx-smoke", family="moe", n_layers=2, d_model=96,
        n_heads=6, n_kv_heads=2, d_ff=192, vocab=512,
        moe=MoEDims(n_experts=8, top_k=4, d_ff_expert=96),
        dtype=torch.float32)
