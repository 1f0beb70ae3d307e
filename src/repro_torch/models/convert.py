"""Carry the JAX package's weights and caches across to the port.

``params_from_numpy(cfg, tree)`` takes the tree of the JAX package's
``Model.init`` read back to the host (``jax.device_get``: nested dicts,
``segments`` a list of layer-stacked ``{"b0_dense": ...}`` leaves) and
returns the port's parameters; ``cache_from_numpy`` does the same for a
cache tree of ``Model.make_cache``, so both engines can start from the
same lane state.  Both take numpy arrays only; neither imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.state import resolve_device
from repro_torch.models.model import ModelConfig, cast_params


def _tensors(tree, leaf):
    if isinstance(tree, dict):
        return {k: _tensors(v, leaf) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tensors(v, leaf) for v in tree]
    return leaf(tree)


def params_from_numpy(cfg: ModelConfig, tree, device=None):
    """The port's parameters (``cfg.dtype``; the leaves under
    ``model.F32_KEYS`` -- norms, the RG-LRU's ``lam`` -- float32) on
    ``device`` (default: the CUDA card)."""
    device = resolve_device(device)
    f32 = _tensors(tree, lambda a: torch.from_numpy(
        np.asarray(a, dtype=np.float32).copy()))
    return cast_params(cfg, f32, device)


# cache leaves held in float32 whatever cfg.dtype: the RG-LRU state
_F32_STATE = ("h", "conv")


def cache_from_numpy(cfg: ModelConfig, tree, device=None):
    """The port's cache: ``pos`` int32, the RG-LRU state (``h``,
    ``conv``) float32, every other leaf (GQA's ``k`` / ``v``, MLA's
    latent ``ckv`` and rope key ``kr``) in ``cfg.dtype``."""
    device = resolve_device(device)

    def dtype_of(name):
        if name == "pos":
            return torch.int32
        return torch.float32 if name in _F32_STATE else cfg.dtype

    def convert(blk):
        return {name: torch.from_numpy(
                    np.asarray(a, dtype=np.int32 if name == "pos"
                               else np.float32).copy()).to(
                    device=device, dtype=dtype_of(name))
                for name, a in blk.items()}

    return [{key: convert(blk) for key, blk in seg.items()} for seg in tree]
