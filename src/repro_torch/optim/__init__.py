from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.optim.dist import (
    compress_int8, decompress_int8, make_error_feedback,
)

__all__ = [
    "AdamWConfig", "adamw_init", "adamw_update", "warmup_cosine",
    "compress_int8", "decompress_int8", "make_error_feedback",
]
