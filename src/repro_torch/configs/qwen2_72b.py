"""qwen2-72b [dense]: 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064, QKV bias [arXiv:2407.10671; hf].

~72.7 B parameters, ~145 GB in bfloat16: more than one card holds.  On
one H100 the port serves it at full width and 8 of its 80 layers
(``dataclasses.replace(full(), n_layers=8)``: 9,512,902,656 parameters,
17.7 GiB in bfloat16); the CPU runs the reduced config.
``remat="dots"`` as in the JAX package; its ``fsdp=True`` (a sharding
policy) is not ported."""

import torch

from repro_torch.models.model import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen2-72b", family="dense", n_layers=80, d_model=8192,
        n_heads=64, n_kv_heads=8, d_ff=29568, vocab=152064,
        qkv_bias=True, rope_base=1e6, remat="dots")


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen2-72b-smoke", family="dense", n_layers=3, d_model=128,
        n_heads=8, n_kv_heads=2, d_ff=320, vocab=512,
        qkv_bias=True, dtype=torch.float32)
