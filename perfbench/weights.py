"""The benchmark's weights, drawn from the seed on the device: one
``randn`` call a leaf, in the dtype the model is served and trained in
(norm scales in float32), in the order the configuration's reference
lists its leaves.  The same seed gives the same tensors bit for bit, so
the reference, run after the program's state is freed, draws them again
instead of keeping a copy."""

from __future__ import annotations

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32}


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed % (1 << 63))


def iter_draw(specs, seed: int, device, dtype: torch.dtype):
    """``(name, tensor)`` for every leaf of ``specs`` in order, drawn one
    at a time (a caller may drop each before the next)."""
    gen = _generator(seed, device)
    for name, shape, init in specs:
        if init[0] == "normal":
            t = torch.randn(shape, generator=gen, device=device, dtype=dtype)
            yield name, t.mul_(init[1])
        elif init[0] == "ones":
            yield name, torch.ones(shape, device=device)
        else:
            yield name, torch.zeros(shape, device=device, dtype=dtype)


def draw(specs, seed: int, device, dtype: torch.dtype) -> dict:
    return dict(iter_draw(specs, seed, device, dtype))


def batch_seed(seed: int) -> int:
    """The token stream's seed: another stream than the weights'."""
    return (seed * 6364136223846793005 + 1442695040888963407) % (1 << 63)


def sample_index(seed: int, leaf: int, numel: int, device, k: int = 1 << 20):
    """Up to ``k`` positions of a leaf of ``numel`` words, drawn from the
    seed and the leaf's place in the draw order (all of them when the
    leaf is no larger)."""
    if numel <= k:
        return torch.arange(numel, device=device)
    gen = _generator(batch_seed(seed) + 7919 * (leaf + 1), device)
    return torch.randint(0, numel, (k,), generator=gen, device=device)
