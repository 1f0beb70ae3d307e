"""Model assembly, dense part: config -> init / forward / prefill /
decode (the port of ``repro.models.model``).

Layers are grouped into homogeneous *segments* (a superblock pattern x a
repeat count) with layer-stacked parameter and cache leaves, as in the
JAX package; a Python loop over the stacked layers takes the place of
``lax.scan``.  Only the dense family is ported: ``[("dense",)] x L``.

Parameters are a dict tree like the JAX package's.  Matrices, embeddings
and biases are held in ``cfg.dtype`` (the JAX package casts its float32
parameters to ``cfg.dtype`` at every use, so casting once gives the same
values); norm scales and biases stay float32, as the norms read them.
Ring caches are written in place (``models.attention``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.core.state import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import blocks as bl
from repro_torch.tree import tree_leaves

# families and options of the JAX package that wait for a later slice
_NOT_PORTED = "is not ported to repro_torch yet (ROADMAP queue 1 item 11)"
NORM_KEYS = ("ln1", "ln2", "final_norm")     # float32 subtrees


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense (moe | vlm | hybrid | ssm | audio
                                 # raise until ported)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0
    qkv_bias: bool = False
    norm: str = "rms"            # rms | ln
    mlp: str = "swiglu"          # swiglu | gelu
    rope_base: float = 10000.0
    tie_embeddings: bool = False
    moe: Any = None              # MoE dims: not ported
    mla: Any = None              # MLA dims: not ported
    aux_loss_weight: float = 0.01
    dtype: torch.dtype = torch.bfloat16

    @property
    def dh(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    def segments(self) -> list[tuple[tuple[str, ...], int]]:
        if self.family != "dense":
            raise NotImplementedError(f"model family {self.family!r} "
                                      f"{_NOT_PORTED}")
        return [(("dense",), self.n_layers)]

    def num_params(self, params) -> int:
        return sum(t.numel() for t in tree_leaves(params))


def _layers(tree, n: int) -> list:
    """Every layer of a layer-stacked tree, as views (no copy) from one
    ``unbind`` per leaf.  Autograd gives an unbind one backward that
    stacks the layers' gradients once; indexing each layer instead would
    give every layer a full-size zero gradient of the stacked leaf to
    sum."""
    if isinstance(tree, dict):
        per_key = {k: _layers(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return list(torch.unbind(tree, 0))


def cast_params(cfg: ModelConfig, tree, device, *, f32: bool = False):
    """``tree`` with every leaf on ``device`` in ``cfg.dtype``, except
    the norms' leaves (float32)."""
    if isinstance(tree, dict):
        return {k: cast_params(cfg, v, device, f32=f32 or k in NORM_KEYS)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [cast_params(cfg, v, device, f32=f32) for v in tree]
    return tree.to(device=device, dtype=torch.float32 if f32 else cfg.dtype)


# --------------------------------------------------------------------------
# per-block init / apply / cache; ``lead`` is the segment's layer axis
# --------------------------------------------------------------------------

def _init_norm(cfg, gen, lead=()):
    ones = torch.ones(lead + (cfg.d_model,), device=gen.device)
    if cfg.norm == "ln":
        return {"scale": ones, "bias": torch.zeros_like(ones)}
    return {"scale": ones}


def _norm(cfg, p, x):
    if cfg.norm == "ln":
        return bl.layer_norm(x, p["scale"], p["bias"])
    return bl.rms_norm(x, p["scale"])


def _init_mlp(cfg, gen, lead=()):
    n, d, f = len(lead), cfg.d_model, cfg.d_ff
    if cfg.mlp == "gelu":
        return {"wi": bl.dense_init(gen, lead + (d, f), n),
                "bi": torch.zeros(lead + (f,), device=gen.device),
                "wo": bl.dense_init(gen, lead + (f, d), n),
                "bo": torch.zeros(lead + (d,), device=gen.device)}
    return {"wg": bl.dense_init(gen, lead + (d, f), n),
            "wu": bl.dense_init(gen, lead + (d, f), n),
            "wd": bl.dense_init(gen, lead + (f, d), n)}


def _mlp(cfg, p, x):
    if cfg.mlp == "gelu":
        return bl.gelu_mlp(x, p["wi"], p["bi"], p["wo"], p["bo"])
    return bl.swiglu(x, p["wg"], p["wu"], p["wd"])


# the dense block: segments() admits no other kind

def _init_block(cfg, gen, lead=()):
    d, H, K, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.dh
    return {"ln1": _init_norm(cfg, gen, lead),
            "attn": attn.init_gqa(gen, d, H, K, dh, cfg.qkv_bias, lead),
            "ln2": _init_norm(cfg, gen, lead),
            "mlp": _init_mlp(cfg, gen, lead)}


def _block_cache(cfg, B: int, slots: int, device, lead=()):
    return attn.make_kv_cache(B, slots, cfg.n_kv_heads, cfg.dh, cfg.dtype,
                              device, lead)


def _apply_block(cfg, p, x, positions, *, cache=None, fresh=False,
                 differentiable=False):
    """Returns (x, cache)."""
    h = _norm(cfg, p["ln1"], x)
    a, cache = attn.gqa(p["attn"], h, positions, H=cfg.n_heads,
                        K=cfg.n_kv_heads, dh=cfg.dh, rope_base=cfg.rope_base,
                        cache=cache, fresh=fresh,
                        differentiable=differentiable)
    x = x + a
    h = _norm(cfg, p["ln2"], x)
    return x + _mlp(cfg, p["mlp"], h), cache


# --------------------------------------------------------------------------
# the Model
# --------------------------------------------------------------------------

class Model:
    """Functional model: explicit params, no framework magic.  Lives on
    ``device`` (default: the CUDA card)."""

    def __init__(self, cfg: ModelConfig, device=None):
        if cfg.moe is not None or cfg.mla is not None:
            raise NotImplementedError(f"MoE / MLA attention {_NOT_PORTED}")
        self.cfg = cfg
        self.segs = cfg.segments()
        self.device = resolve_device(device)
        # sqrt(d_model) in cfg.dtype, as the JAX package rounds it
        self._embed_scale = torch.tensor(math.sqrt(cfg.d_model),
                                         dtype=cfg.dtype)

    # -- init ---------------------------------------------------------------

    def init(self, gen: torch.Generator) -> dict:
        """Random weights from ``gen``, a generator on the model's
        device."""
        if gen.device.type != self.device.type:
            raise ValueError(f"init: generator on {gen.device}, model on "
                             f"{self.device}")
        cfg = self.cfg
        params: dict[str, Any] = {
            "embed": bl.embed_init(gen, (cfg.vocab, cfg.d_model)),
            "final_norm": _init_norm(cfg, gen)}
        if not cfg.tie_embeddings:
            params["lm_head"] = bl.dense_init(gen, (cfg.d_model, cfg.vocab))
        params["segments"] = [
            {f"b{i}_{kind}": _init_block(cfg, gen, (reps,))
             for i, kind in enumerate(pat)}
            for pat, reps in self.segs]
        return cast_params(cfg, params, self.device)

    # -- forward -------------------------------------------------------------

    def _embed_in(self, params, tokens):
        x = params["embed"].to(self.cfg.dtype)[tokens]
        return x * self._embed_scale

    def _unembed(self, params, x):
        x = _norm(self.cfg, params["final_norm"], x)
        if self.cfg.tie_embeddings:
            return x @ params["embed"].to(x.dtype).T
        return x @ params["lm_head"].to(x.dtype)

    def _run_segments(self, params, x, positions, *, caches=None,
                      fresh=False, differentiable=False):
        """Every layer in order; returns (x, caches)."""
        cfg = self.cfg
        for si, (pat, reps) in enumerate(self.segs):
            seg_params = {key: _layers(p, reps)
                          for key, p in params["segments"][si].items()}
            seg_cache = None if caches is None else {
                key: _layers(c, reps) for key, c in caches[si].items()}
            for layer in range(reps):
                for i, kind in enumerate(pat):
                    key = f"b{i}_{kind}"
                    c = None if seg_cache is None else seg_cache[key][layer]
                    x, _ = _apply_block(cfg, seg_params[key][layer],
                                        x, positions, cache=c, fresh=fresh,
                                        differentiable=differentiable)
        return x, caches

    def _positions(self, B: int, S: int):
        return torch.arange(S, device=self.device).expand(B, S)

    def forward_train(self, params, batch, *, differentiable=False):
        """batch: {"tokens": (B, S)} -> (logits (B, S, vocab), aux);
        ``aux`` (the MoE loss) is 0 for dense.  Attention goes through
        the forward-only flash kernel unless ``differentiable`` asks for
        the plain route that autograd differentiates (``loss``)."""
        x = self._embed_in(params, batch["tokens"])
        B, S = x.shape[:2]
        x, _ = self._run_segments(params, x, self._positions(B, S),
                                  differentiable=differentiable)
        return (self._unembed(params, x),
                torch.zeros((), dtype=torch.float32, device=self.device))

    def loss(self, params, batch):
        """Mean next-token cross-entropy of ``batch["labels"]`` plus
        ``aux_loss_weight * aux``, through the differentiable forward."""
        logits, aux = self.forward_train(params, batch, differentiable=True)
        ce = bl.softmax_xent(logits, batch["labels"])
        return ce + self.cfg.aux_loss_weight * aux

    # -- serving -------------------------------------------------------------

    def make_cache(self, B: int, slots: int):
        return [{f"b{i}_{kind}": _block_cache(self.cfg, B, slots,
                                              self.device, (reps,))
                 for i, kind in enumerate(pat)}
                for pat, reps in self.segs]

    @staticmethod
    def is_fresh(cache) -> bool:
        """Every slot of every layer unwritten (pos -1): one device sync."""
        fresh = [(blk["pos"] == -1).all() for seg in cache
                 for blk in seg.values()]
        return bool(torch.stack(fresh).all())

    def prefill(self, params, batch, cache):
        """Run the prompt through the model, filling the cache in place.

        Returns (logits_last (B, vocab), cache).  On a fresh cache a
        prompt of at most W tokens attends through the flash kernel."""
        x = self._embed_in(params, batch["tokens"])
        B, S = x.shape[:2]
        x, cache = self._run_segments(params, x, self._positions(B, S),
                                      caches=cache,
                                      fresh=self.is_fresh(cache))
        logits = self._unembed(params, x[:, -1:])
        return logits[:, 0], cache

    def decode_step(self, params, cache, token, pos):
        """One decode step. token: (B, 1) ids; pos: (B,) absolute
        positions.  Returns (logits (B, vocab), cache)."""
        x = self._embed_in(params, token)
        positions = pos[:, None]
        x, cache = self._run_segments(params, x, positions, caches=cache)
        logits = self._unembed(params, x)
        return logits[:, 0], cache


def build_model(cfg: ModelConfig, device=None) -> Model:
    return Model(cfg, device=device)
