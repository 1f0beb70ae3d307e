"""Model assembly, dense part: config -> init / forward / prefill /
decode (the port of ``repro.models.model``).

Layers are grouped into homogeneous *segments* (a superblock pattern x a
repeat count) with layer-stacked parameter and cache leaves, as in the
JAX package; a Python loop over the stacked layers takes the place of
``lax.scan``.  All six families are ported: dense and audio, both
``[("dense",)] x L`` (audio: LayerNorm / GELU blocks fed frame
embeddings, the ``frontend="embeddings"`` stub, in place of tokens),
moe, ``[("dense",)] x first_k_dense + [("moe",)] x rest`` (the MoE block
is the dense block with :mod:`repro_torch.models.moe`'s routed experts
in place of the MLP; ``Model(..., ep=)`` runs them expert-parallel over
a kernel axis, as the JAX package's mesh does), vlm,
``[("dense",) * (k - 1) + ("cross",)] x L / k`` with ``k =
cross_every`` (the cross block attends from the text stream to image
features, ``attention.cross_attention``; it has no cache, and every
decode step recomputes the image K/V, as in the JAX package), and
hybrid, ``[block_pattern] x (L // len) + [block_pattern[:L % len]]``
(recurrentgemma: two RG-LRU blocks, :mod:`repro_torch.models.recurrent`,
to one local-attention block, GQA with a ``window`` and a ring of
``min(slots, window)`` slots; the RG-LRU state is float32), and ssm,
``[("mlstm",) * (k - 1) + ("slstm",)] x L / k`` with ``k =
slstm_every`` (xlstm: :mod:`repro_torch.models.xlstm`'s mLSTM and sLSTM
cells, each a whole block ``{"cell": ...}`` with its own norms and
residuals; their float32 state is written in place).
``cfg.mla`` gives the dense and MoE blocks DeepSeek-V2's latent
attention (``attention.mla``) in place of GQA, with a latent ring
cache.

Parameters are a dict tree like the JAX package's.  Matrices, embeddings
and biases are held in ``cfg.dtype`` (the JAX package casts its float32
parameters to ``cfg.dtype`` at every use, so casting once gives the same
values); norm scales and biases stay float32, as the norms read them
(MLA's latent norms ``qln`` and ``kvln`` and cross-attention's ``qln``
and ``kln`` too), and so do cross-attention's ``gate``, whose tanh
the JAX package takes in float32, the RG-LRU's ``lam``, whose
softplus it takes in float32 (``a`` near 0.9-0.999 makes ``sqrt(1 -
a^2)`` sensitive to it), the xLSTM cells' norm scales ``ln`` and ``gn``
and the sLSTM's recurrent ``r``, which its time loop reads in float32.
Ring caches are written in place (``models.attention``).
``cfg.seq_shard`` (with ``tp`` off and an ``ep`` mesh) runs every GQA
prompt pass as ring attention over the mesh's kernels
(:mod:`repro_torch.models.ring_attention`).

``cfg.remat`` is the JAX package's activation checkpointing policy, on
the same unit: a training pass (no cache, autograd recording) runs each
superblock -- one pass over a segment's pattern, with its aux loss -- as
one ``torch.utils.checkpoint`` region, which keeps the region's input
and recomputes the rest in the backward.  ``"full"`` keeps nothing
else; ``"dots"`` (``jax.checkpoint_policies.
dots_with_no_batch_dims_saveable``) also keeps the output of every
matrix product without a batch dimension (:func:`dots_policy`);
``"none"`` keeps every intermediate.  Serving, prefill and decode never
enter a region.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.core.state import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import blocks as bl
from repro_torch.models import moe as moe_lib
from repro_torch.models import recurrent as rec
from repro_torch.models import xlstm as xl
from repro_torch.tree import tree_leaves, tree_unstack

# float32 subtrees: the block norms, MLA's latent norms, cross-attention's
# q / k norms and its gate, the RG-LRU's lam, the xLSTM cells' norms (ln,
# gn; the sLSTM's ln2 is a block norm) and the sLSTM's recurrent r
F32_KEYS = ("ln1", "ln2", "final_norm", "qln", "kvln", "kln", "gate", "lam",
            "ln", "gn", "r")

# ModelConfig.remat's values, the JAX package's
REMAT = ("none", "full", "dots")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | audio | moe | vlm | hybrid | ssm
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
    moe: Any = None              # moe_lib.MoEDims of the moe family
    first_k_dense: int = 0       # moe: dense layers before the MoE ones
    mla: attn.MLADims | None = None  # MLA attention in place of GQA
    cross_every: int = 0         # vlm: every k-th layer is a cross layer
    n_image_tokens: int = 0      # vlm: image features a sequence
    # hybrid (recurrentgemma): the superblock, the local layers' window,
    # the RG-LRU width (0: d_model)
    block_pattern: tuple[str, ...] = ()
    window: int = 0
    lru_width: int = 0
    # ssm (xlstm): every k-th block an sLSTM (0: mLSTM only), the mLSTM's
    # up-projection factor and its chunk length
    slstm_every: int = 0
    mlstm_pf: float = 2.0
    mlstm_chunk: int = 64
    aux_loss_weight: float = 0.01
    # frontend: tokens | embeddings (audio frames, a stubbed modality)
    frontend: str = "tokens"
    dtype: torch.dtype = torch.bfloat16
    # parallelism, read to choose the route as the JAX package does: with
    # ``seq_shard`` and no ``tp``, over a ``Model(..., ep=)`` mesh of more
    # than one kernel, GQA prompt passes take ring attention (the sequence
    # sharded over the kernels); ``tp`` off also turns the MoE island off
    tp: bool = True
    seq_shard: bool = False
    remat: str = "none"          # none | full | dots (activation ckpt policy)
    sub_quadratic: bool = False  # may run long_500k (the JAX package's
                                 # dry-run shapes; no port caller yet)

    @property
    def dh(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def dr(self) -> int:
        return self.lru_width or self.d_model

    def segments(self) -> list[tuple[tuple[str, ...], int]]:
        L = self.n_layers
        if self.family in ("dense", "audio"):
            return [(("dense",), L)]
        if self.family == "moe":
            segs = []
            if self.first_k_dense:
                segs.append((("dense",), self.first_k_dense))
            segs.append((("moe",), L - self.first_k_dense))
            return segs
        if self.family == "vlm":
            k = self.cross_every
            if k < 1 or L % k:
                raise ValueError(f"{self.name}: {L} layers do not split into "
                                 f"superblocks of cross_every = {k}")
            return [(("dense",) * (k - 1) + ("cross",), L // k)]
        if self.family == "hybrid":
            pat = self.block_pattern or ("rglru", "rglru", "attn_local")
            full, rem = divmod(L, len(pat))
            segs = [(pat, full)]
            if rem:
                segs.append((pat[:rem], 1))
            return segs
        if self.family == "ssm":
            k = self.slstm_every
            if not k:
                return [(("mlstm",), L)]
            if L % k:
                raise ValueError(f"{self.name}: {L} layers do not split into "
                                 f"superblocks of slstm_every = {k}")
            return [(("mlstm",) * (k - 1) + ("slstm",), L // k)]
        raise ValueError(f"unknown model family {self.family!r}")

    def num_params(self, params) -> int:
        return sum(t.numel() for t in tree_leaves(params))


def cast_params(cfg: ModelConfig, tree, device, *, f32: bool = False):
    """``tree`` with every leaf on ``device`` in ``cfg.dtype``, except
    the leaves under ``F32_KEYS`` (float32)."""
    if isinstance(tree, dict):
        return {k: cast_params(cfg, v, device, f32=f32 or k in F32_KEYS)
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


def _mlp(cfg, p, x, unread=False):
    if cfg.mlp == "gelu":
        return bl.gelu_mlp(x, p["wi"], p["bi"], p["wo"], p["bo"],
                           unread=unread)
    return bl.swiglu(x, p["wg"], p["wu"], p["wd"], unread=unread)


# the dense, MoE, cross, local-attention, RG-LRU, mLSTM and sLSTM blocks:
# segments() admits no other kind

def _init_block(cfg, kind, gen, lead=()):
    d, H, K, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.dh
    if kind == "mlstm":
        return {"cell": xl.init_mlstm(gen, d, H, cfg.mlstm_pf, lead=lead)}
    if kind == "slstm":
        return {"cell": xl.init_slstm(gen, d, H, lead=lead)}
    if kind == "rglru":     # n_heads gate blocks, as in the JAX package
        return {"ln1": _init_norm(cfg, gen, lead),
                "rnn": rec.init_rglru(gen, d, cfg.dr, H, lead=lead),
                "ln2": _init_norm(cfg, gen, lead),
                "mlp": _init_mlp(cfg, gen, lead)}
    if kind == "attn_local":
        return {"ln1": _init_norm(cfg, gen, lead),
                "attn": attn.init_gqa(gen, d, H, K, dh, cfg.qkv_bias, lead),
                "ln2": _init_norm(cfg, gen, lead),
                "mlp": _init_mlp(cfg, gen, lead)}
    if kind == "cross":
        return {"ln1": _init_norm(cfg, gen, lead),
                "xattn": attn.init_cross(gen, d, H, K, dh, lead),
                "ln2": _init_norm(cfg, gen, lead),
                "mlp": _init_mlp(cfg, gen, lead)}
    a = (attn.init_mla(gen, d, H, cfg.mla, lead) if cfg.mla
         else attn.init_gqa(gen, d, H, K, dh, cfg.qkv_bias, lead))
    p = {"ln1": _init_norm(cfg, gen, lead), "attn": a,
         "ln2": _init_norm(cfg, gen, lead)}
    if kind == "moe":
        # each expert stack is cast to cfg.dtype as it is drawn
        p["moe"] = moe_lib.init_moe(gen, d, cfg.moe, lead, cfg.dtype)
    else:
        p["mlp"] = _init_mlp(cfg, gen, lead)
    return p


def _block_cache(cfg, kind, B: int, slots: int, device, lead=()):
    if kind == "cross":
        return {}   # image kv is recomputed from the (static) image feats
    if kind == "rglru":
        return rec.make_rglru_state(B, cfg.dr, device, lead=lead)
    if kind == "mlstm":
        return xl.make_mlstm_state(B, cfg.d_model, cfg.n_heads, device,
                                   cfg.mlstm_pf, lead=lead)
    if kind == "slstm":
        return xl.make_slstm_state(B, cfg.d_model, device, lead=lead)
    if kind == "attn_local":
        return attn.make_kv_cache(B, min(slots, cfg.window), cfg.n_kv_heads,
                                  cfg.dh, cfg.dtype, device, lead)
    if cfg.mla:
        return attn.make_mla_cache(B, slots, cfg.mla, cfg.dtype, device,
                                   lead)
    return attn.make_kv_cache(B, slots, cfg.n_kv_heads, cfg.dh, cfg.dtype,
                              device, lead)


def _apply_block(cfg, kind, p, x, positions, *, cache=None, fresh=False,
                 differentiable=False, ep=None, image_feats=None, ring=None,
                 last=False):
    """Returns (x, aux): the MoE block's load-balance loss, None for any
    other block.  ``last``: the block ends its superblock, so its last
    batch-free product ends a checkpoint region and the backward never
    reads its output (``blocks.product(..., unread=True)``).  ``ep``:
    the expert-parallel island, or None.  ``ring``: the ring-attention
    mesh, or None; only a GQA block without a window
    takes it (MLA and cross blocks ignore it, as in the JAX package).
    ``image_feats``: the cross block's keys and values, ``(B, N,
    d_model)``.  An RG-LRU, mLSTM or sLSTM block's ``cache`` is its
    state, written in place; the xLSTM cells norm their own input."""
    if kind == "mlstm":
        x, _ = xl.mlstm_block(p["cell"], x, nh=cfg.n_heads,
                              chunk=cfg.mlstm_chunk, state=cache,
                              unread=last)
        return x, None
    if kind == "slstm":
        x, _ = xl.slstm_block(p["cell"], x, nh=cfg.n_heads, state=cache,
                              unread=last)
        return x, None
    h = _norm(cfg, p["ln1"], x)
    if kind == "rglru":
        r, _ = rec.rglru_block(p["rnn"], h, state=cache)
        x = x + r
        h = _norm(cfg, p["ln2"], x)
        return x + _mlp(cfg, p["mlp"], h, unread=last), None
    if kind == "cross":
        if image_feats is None:
            raise ValueError(f"{cfg.name}: a cross-attention block needs "
                             f"image_feats (B, N, d_model), got None; pass "
                             f"batch['image_feats'] or "
                             f"decode_step(..., image_feats=)")
        x = x + attn.cross_attention(p["xattn"], h, image_feats,
                                     H=cfg.n_heads, K=cfg.n_kv_heads,
                                     dh=cfg.dh,
                                     differentiable=differentiable)
        h = _norm(cfg, p["ln2"], x)
        return x + _mlp(cfg, p["mlp"], h, unread=last), None
    if cfg.mla and kind != "attn_local":
        a, _ = attn.mla(p["attn"], h, positions, H=cfg.n_heads, dims=cfg.mla,
                        cache=cache, fresh=fresh,
                        differentiable=differentiable)
    else:
        window = cfg.window if kind == "attn_local" else 0
        a, _ = attn.gqa(p["attn"], h, positions, H=cfg.n_heads,
                        K=cfg.n_kv_heads, dh=cfg.dh, window=window,
                        rope_base=cfg.rope_base, cache=cache, fresh=fresh,
                        differentiable=differentiable,
                        ring=None if window else ring)
    x = x + a
    h = _norm(cfg, p["ln2"], x)
    if kind != "moe":
        return x + _mlp(cfg, p["mlp"], h, unread=last), None
    if ep is None:
        f, aux = moe_lib.moe_ffn(p["moe"], h, cfg.moe, unread=last)
        return x + f, aux
    f, aux = ep(p["moe"], h)
    if cfg.moe.n_shared:            # shared experts run outside the island
        f = f + moe_lib.shared_experts(p["moe"], h, unread=last)
    return x + f, aux


# --------------------------------------------------------------------------
# activation checkpointing (cfg.remat)
# --------------------------------------------------------------------------

def dots_policy(ctx, op, *args, **kwargs):
    """The ``dots`` policy: save the output of ``aten.mm`` but the
    region's last product, recompute every other operation.

    JAX's ``dots_with_no_batch_dims_saveable`` saves a ``dot_general``
    with no dimension shared by both operands and the output.  The
    port writes every such product -- the weight projections: the MLPs,
    q / k / v / o, MLA's latent projections, the RG-LRU and xLSTM in and
    out projections, the router, the shared experts -- as ``x @ W`` on
    a 2-D weight, which dispatches ``aten.mm`` (a 2-D by 2-D product has
    no batch dimension), and every product with one -- attention's
    scores and values, the block-diagonal gates, the experts, the
    xLSTM's chunk contractions and its recurrence -- as ``einsum``,
    ``bmm`` or a batched ``matmul``, which dispatch ``aten.bmm``.  The
    decision reads the operation, not ``bmm``'s batch size: an einsum
    dispatches ``bmm`` with a batch of 1 for a batch-free contraction as
    well as for a batched one whose batch is 1, so a batch-free product
    must not be written as an einsum.

    The superblock's last batch-free product (its last block's down
    projection, or the shared experts') runs as ``blocks.product(...,
    unread=True)``: only the residual add that ends the region reads its
    output, the backward never does, and the recomputation stops before
    it (early stop: its inputs are the region's last saves).  JAX's
    partial evaluation drops that output; so does this policy, and
    ``dots`` keeps what ``saved_residuals`` lists."""
    if op in _SAVED_BY_DOTS and not bl.in_unread_product():
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


_SAVED_BY_DOTS = frozenset({torch.ops.aten.mm.default})


def _dots_contexts():
    # the module global is read at every region, so a test can wrap it
    return ckpt.create_selective_checkpoint_contexts(dots_policy)


def _checkpointed(remat: str, fn, *args):
    """``fn(*args)`` as one checkpoint region under ``remat`` ("full" or
    "dots").  Non-reentrant, so autograd reaches the tensors ``fn``
    closes over and the parameter dicts in ``args``; the model draws no
    random numbers, so no RNG state is stashed."""
    kw = {"context_fn": _dots_contexts} if remat == "dots" else {}
    return ckpt.checkpoint(fn, *args, use_reentrant=False,
                           preserve_rng_state=False, **kw)


# --------------------------------------------------------------------------
# the Model
# --------------------------------------------------------------------------

class Model:
    """Functional model: explicit params, no framework magic.  Lives on
    ``device`` (default: the CUDA card).

    ``ep`` (a :class:`~repro_torch.models.moe.ExpertMesh`) runs the MoE
    layers' routed experts as the expert-parallel island over its
    kernels, forward and backward; without it, or where the experts do
    not split over the kernels, they run on one device (``moe_ffn``).  With
    ``cfg.seq_shard`` and not ``cfg.tp`` the same mesh carries ring
    attention instead: every GQA prompt pass (S > 1) without a window
    shards its sequence over the kernels (``_ring_ctx``)."""

    def __init__(self, cfg: ModelConfig, device=None, ep=None):
        if cfg.family == "moe" and cfg.moe is None:
            raise ValueError(f"{cfg.name}: the moe family needs cfg.moe")
        if cfg.remat not in REMAT:
            raise ValueError(f"{cfg.name}: unknown remat policy "
                             f"{cfg.remat!r}; known: {REMAT}")
        self.cfg = cfg
        self.segs = cfg.segments()
        self.device = resolve_device(device)
        self.ep = ep
        self._island = self._ep_ctx()
        # sqrt(d_model) in cfg.dtype, as the JAX package rounds it
        self._embed_scale = torch.tensor(math.sqrt(cfg.d_model),
                                         dtype=cfg.dtype)

    # -- init ---------------------------------------------------------------

    def init(self, gen: torch.Generator) -> dict:
        """Random weights from ``gen``, a generator on the model's
        device.  Each part is cast as it is drawn, so no more than one
        block's float32 draws are held beside the cast weights."""
        if gen.device.type != self.device.type:
            raise ValueError(f"init: generator on {gen.device}, model on "
                             f"{self.device}")
        cfg = self.cfg

        def cast(tree):
            return cast_params(cfg, tree, self.device)

        params: dict[str, Any] = {
            "embed": cast(bl.embed_init(gen, (cfg.vocab, cfg.d_model))),
            "final_norm": _init_norm(cfg, gen)}
        if not cfg.tie_embeddings:
            params["lm_head"] = cast(bl.dense_init(gen, (cfg.d_model,
                                                         cfg.vocab)))
        params["segments"] = [
            {f"b{i}_{kind}": cast(_init_block(cfg, kind, gen, (reps,)))
             for i, kind in enumerate(pat)}
            for pat, reps in self.segs]
        return cast(params)

    def _ep_ctx(self):
        """The expert-parallel island ``(p_moe, h) -> (out, aux)``, or
        None: no ``ep``, no MoE, no ``tp``, one kernel, or experts that do
        not split over the kernels (the JAX package's ``_ep_ctx``
        conditions)."""
        cfg, ep = self.cfg, self.ep
        if (ep is None or cfg.moe is None or not cfg.tp
                or ep.ctx.num_kernels == 1):
            return None
        if cfg.moe.n_experts % ep.ctx.num_kernels:
            return None

        def run(p_moe, h):
            return moe_lib.moe_routed_island(p_moe, h, cfg.moe, ep,
                                             cfg.dtype)
        return run

    def _ring_ctx(self):
        """The ring-attention mesh (``ep``), or None: only in the no-TP
        sequence-parallel mode (``seq_shard`` set, ``tp`` not) over more
        than one kernel, the JAX package's ``_ring_ctx`` conditions.
        With ``tp`` the JAX package runs attention head-sharded instead;
        on one card that is plain attention."""
        cfg, ep = self.cfg, self.ep
        if not cfg.seq_shard or cfg.tp or ep is None \
                or ep.ctx.num_kernels == 1:
            return None
        return ep

    # -- forward -------------------------------------------------------------

    def _embed_in(self, params, batch):
        """The first activations: frame embeddings cast to ``cfg.dtype``
        as they are, or token embeddings scaled by sqrt(d_model)."""
        if self.cfg.frontend == "embeddings":
            return batch["embeddings"].to(self.cfg.dtype)
        x = params["embed"].to(self.cfg.dtype)[batch["tokens"]]
        return x * self._embed_scale

    def _unembed(self, params, x):
        x = _norm(self.cfg, params["final_norm"], x)
        if self.cfg.tie_embeddings:
            return x @ params["embed"].to(x.dtype).T
        return x @ params["lm_head"].to(x.dtype)

    def _run_segments(self, params, x, positions, *, caches=None,
                      fresh=False, differentiable=False, image_feats=None):
        """Every layer in order; returns (x, caches, aux), ``aux`` the
        sum of the MoE layers' losses (float32 0 without any).
        ``image_feats``: what the cross blocks attend to, or None.  A
        training pass (no cache, autograd recording) runs each
        superblock as one checkpoint region under ``cfg.remat``."""
        cfg = self.cfg
        ring = self._ring_ctx() if x.shape[1] > 1 else None
        remat = cfg.remat if caches is None and torch.is_grad_enabled() \
            else "none"
        aux_total = torch.zeros((), dtype=torch.float32, device=self.device)
        for si, (pat, reps) in enumerate(self.segs):
            seg_params = {key: tree_unstack(p, reps)
                          for key, p in params["segments"][si].items()}
            seg_cache = None if caches is None else {
                key: tree_unstack(c, reps) for key, c in caches[si].items()}

            def superblock(x, p_layer, c_layer=None, pat=pat):
                """One pass over ``pat``: (x, the blocks' summed aux or
                None)."""
                aux_sb = None
                for i, kind in enumerate(pat):
                    key = f"b{i}_{kind}"
                    x, aux = _apply_block(
                        cfg, kind, p_layer[key], x, positions,
                        cache=None if c_layer is None else c_layer[key],
                        fresh=fresh, differentiable=differentiable,
                        ep=self._island, image_feats=image_feats, ring=ring,
                        last=i == len(pat) - 1)
                    if aux is not None:
                        aux_sb = aux if aux_sb is None else aux_sb + aux
                return x, aux_sb

            for layer in range(reps):
                p_layer = {key: p[layer] for key, p in seg_params.items()}
                if seg_cache is not None:
                    x, aux = superblock(x, p_layer, {
                        key: c[layer] for key, c in seg_cache.items()})
                elif remat == "none":
                    x, aux = superblock(x, p_layer)
                else:
                    x, aux = _checkpointed(remat, superblock, x, p_layer)
                if aux is not None:
                    aux_total = aux_total + aux
        return x, caches, aux_total

    def _positions(self, B: int, S: int):
        return torch.arange(S, device=self.device).expand(B, S)

    def forward_train(self, params, batch, *, differentiable=False):
        """batch: {"tokens": (B, S)} or {"embeddings": (B, S, d)}, and
        the vlm family's {"image_feats": (B, N, d)} ->
        (logits (B, S, vocab), aux);
        ``aux`` (the MoE layers' summed load-balance loss) is 0 without
        MoE layers.  Attention goes through
        the forward-only flash kernel unless ``differentiable`` asks for
        the plain route that autograd differentiates (``loss``)."""
        x = self._embed_in(params, batch)
        B, S = x.shape[:2]
        x, _, aux = self._run_segments(params, x, self._positions(B, S),
                                       differentiable=differentiable,
                                       image_feats=batch.get("image_feats"))
        return self._unembed(params, x), aux

    def loss(self, params, batch):
        """Mean next-token cross-entropy of ``batch["labels"]`` plus
        ``aux_loss_weight * aux``, through the differentiable forward."""
        logits, aux = self.forward_train(params, batch, differentiable=True)
        ce = bl.softmax_xent(logits, batch["labels"])
        return ce + self.cfg.aux_loss_weight * aux

    # -- serving -------------------------------------------------------------

    def make_cache(self, B: int, slots: int):
        return [{f"b{i}_{kind}": _block_cache(self.cfg, kind, B, slots,
                                              self.device, (reps,))
                 for i, kind in enumerate(pat)}
                for pat, reps in self.segs]

    @staticmethod
    def is_fresh(cache) -> bool:
        """Every slot of every attention layer unwritten (pos -1): one
        device sync.  Cross blocks have no cache, and a recurrent block's
        state (RG-LRU, mLSTM, sLSTM) has no slots: the prefill carries it
        on whatever it holds."""
        fresh = [(blk["pos"] == -1).all() for seg in cache
                 for blk in seg.values() if "pos" in blk]
        return bool(torch.stack(fresh).all()) if fresh else True

    def prefill(self, params, batch, cache):
        """Run the prompt through the model, filling the cache in place.

        Returns (logits_last (B, vocab), cache).  On a fresh cache a
        prompt of at most W tokens attends through the flash kernel; the
        vlm family's cross blocks attend to ``batch["image_feats"]``
        through it whatever the cache."""
        x = self._embed_in(params, batch)
        B, S = x.shape[:2]
        x, cache, _ = self._run_segments(params, x, self._positions(B, S),
                                         caches=cache,
                                         fresh=self.is_fresh(cache),
                                         image_feats=batch.get("image_feats"))
        logits = self._unembed(params, x[:, -1:])
        return logits[:, 0], cache

    def decode_step(self, params, cache, token, pos, image_feats=None):
        """One decode step. token: (B, 1) ids (or (B, 1, d) embeddings);
        pos: (B,) absolute positions.  VLM decode re-attends the static
        ``image_feats``.  Returns (logits (B, vocab), cache)."""
        key = "embeddings" if self.cfg.frontend == "embeddings" else "tokens"
        x = self._embed_in(params, {key: token})
        positions = pos[:, None]
        x, cache, _ = self._run_segments(params, x, positions,
                                         caches=cache,
                                         image_feats=image_feats)
        logits = self._unembed(params, x)
        return logits[:, 0], cache


def build_model(cfg: ModelConfig, device=None, ep=None) -> Model:
    return Model(cfg, device=device, ep=ep)
