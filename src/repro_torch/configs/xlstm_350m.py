"""xlstm-350m [ssm]: 24L d_model=1024 4H d_ff=0 vocab=50304 -- sLSTM +
mLSTM blocks [arXiv:2405.04517; unverified].  xLSTM[7:1] ratio: every
8th block is sLSTM.  d_ff=0: the FFN lives inside the blocks (mLSTM
up/down pf=2; sLSTM tail MLP pf=4/3).  Sub-quadratic: runs long_500k.

``remat="dots"`` as in the JAX package.  At bf16 the 24 layers (three
superblocks of seven mLSTM blocks and one sLSTM block) and the untied
embedding and head hold 528,283,648 parameters, 1.06 GB: the card serves
and trains it at full width and depth."""

import torch

from repro_torch.models.model import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m", family="ssm", n_layers=24, d_model=1024,
        n_heads=4, n_kv_heads=4, d_ff=0, vocab=50304,
        slstm_every=8, mlstm_chunk=256, sub_quadratic=True, remat="dots")


def reduced() -> ModelConfig:
    return ModelConfig(
        name="xlstm-smoke", family="ssm", n_layers=8, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=0, vocab=512,
        slstm_every=8, mlstm_chunk=16, sub_quadratic=True,
        dtype=torch.float32)
