"""Deterministic, checkpointable data pipeline (the port of
``repro.data.pipeline``; numpy only, so the batches are bitwise the JAX
package's).

The pipeline state is a single integer, the step counter, carried inside
the checkpoint, and batch contents are a pure function of (seed, step)
through counter-based Philox streams indexed by global batch row:
restoring a checkpoint replays no sample and skips none, and ``rows``
gives any slice of a batch.  ``next_batch`` hands the batch to the
trainer's device as int64 token and label tensors (what ``F.embedding``
and ``cross_entropy`` index with).  Token streams are Zipf-distributed
synthetic LM data or windows of a memmap-backed corpus file; the
embeddings frontend and image-feature stubs are float32.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.state import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    batch: int
    seq: int
    seed: int = 0
    kind: str = "tokens"          # tokens | embeddings
    d_model: int = 0              # for embeddings kind
    image_tokens: int = 0         # >0 adds image_feats (VLM stub)
    zipf_a: float = 1.2           # synthetic token distribution
    corpus: str | None = None     # optional memmap token file


class TokenPipeline:
    """state = step counter; ``batch_at(step)`` is pure.  Batches land
    on ``device`` (default: the CUDA card)."""

    def __init__(self, cfg: DataConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self._corpus = None
        if cfg.corpus:
            self._corpus = np.memmap(cfg.corpus, dtype=np.int32, mode="r")

    def init_state(self) -> int:
        return 0

    def rows(self, step: int, lo: int = 0, hi: int | None = None):
        """Generate batch rows [lo, hi) -- the per-host slice at scale."""
        cfg = self.cfg
        hi = cfg.batch if hi is None else hi
        out_tok = np.empty((hi - lo, cfg.seq + 1), np.int32)
        for r in range(lo, hi):
            rng = np.random.Generator(
                np.random.Philox(key=cfg.seed, counter=[0, 0, step, r]))
            if self._corpus is not None:
                start = int(rng.integers(
                    0, max(1, self._corpus.size - cfg.seq - 1)))
                out_tok[r - lo] = np.asarray(
                    self._corpus[start:start + cfg.seq + 1]) % cfg.vocab
            else:
                z = rng.zipf(cfg.zipf_a, size=cfg.seq + 1)
                out_tok[r - lo] = np.minimum(z, cfg.vocab - 1).astype(
                    np.int32)
        return out_tok

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        tok = self.rows(step)
        batch: dict[str, np.ndarray] = {
            "labels": tok[:, 1:].astype(np.int32),
        }
        if cfg.kind == "embeddings":
            rng = np.random.Generator(
                np.random.Philox(key=cfg.seed + 1, counter=[0, 0, step, 0]))
            batch["embeddings"] = rng.standard_normal(
                (cfg.batch, cfg.seq, cfg.d_model), np.float32) * 0.02
        else:
            batch["tokens"] = tok[:, :-1].astype(np.int32)
        if cfg.image_tokens:
            rng = np.random.Generator(
                np.random.Philox(key=cfg.seed + 2, counter=[0, 0, step, 0]))
            batch["image_feats"] = rng.standard_normal(
                (cfg.batch, cfg.image_tokens, cfg.d_model), np.float32) * 0.02
        return batch

    def next_batch(self, state: int):
        """(state) -> (device batch, state+1): tokens and labels int64,
        features float32."""
        host = self.batch_at(state)
        dev = {k: torch.from_numpy(v).to(
            self.device, dtype=torch.int64 if v.dtype == np.int32 else None)
            for k, v in host.items()}
        return dev, state + 1


def write_synthetic_corpus(path: str, n_tokens: int, vocab: int,
                           seed: int = 0):
    """A tiny on-disk corpus for the file-backed path (tests/examples)."""
    rng = np.random.Generator(np.random.Philox(key=seed))
    arr = np.minimum(rng.zipf(1.2, size=n_tokens), vocab - 1).astype(np.int32)
    arr.tofile(path)
    return path
