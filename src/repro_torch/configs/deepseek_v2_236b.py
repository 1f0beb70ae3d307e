"""deepseek-v2-236b [moe]: 60L d_model=5120 128H d_ff=1536(expert)
vocab=102400, MLA kv_lora=512, 2 shared + 160 routed top-6
[arXiv:2405.04434; hf].  Dense first layer (first_k_dense=1) uses the
model's dense intermediate 12288; d_ff_expert=1536 per assignment.

``remat="dots"`` as in the JAX package; its ``fsdp=True`` (a sharding
policy) is not ported.  At bf16 the 60 layers hold 235,741,434,880
parameters (471 GB), more than one card: ``chip_smoke.py`` serves 4 of
them at full width."""

import torch

from repro_torch.models.attention import MLADims
from repro_torch.models.model import ModelConfig
from repro_torch.models.moe import MoEDims


def full() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b", family="moe", n_layers=60, d_model=5120,
        n_heads=128, n_kv_heads=128, d_ff=12288, vocab=102400, d_head=128,
        moe=MoEDims(n_experts=160, top_k=6, d_ff_expert=1536, n_shared=2),
        mla=MLADims(q_lora=1536, kv_lora=512, dh_nope=128, dh_rope=64,
                    dh_v=128),
        first_k_dense=1, remat="dots")


def reduced() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-smoke", family="moe", n_layers=3, d_model=96,
        n_heads=6, n_kv_heads=6, d_ff=192, vocab=512, d_head=16,
        moe=MoEDims(n_experts=8, top_k=3, d_ff_expert=48, n_shared=2),
        mla=MLADims(q_lora=48, kv_lora=24, dh_nope=16, dh_rope=8, dh_v=16),
        first_k_dense=1, dtype=torch.float32)
