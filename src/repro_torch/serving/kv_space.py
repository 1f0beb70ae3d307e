"""KV caches as PGAS Shoal segments (the port of
``repro.serving.kv_space``).

A finished prefill's KV must be able to *move* from a prefill kernel to
a free decode lane, so :class:`KvSegmentSpace` gives every lane a fixed
region of each decode kernel's segment and a layout inside it, all
Python ints:

    lane base address   = lane * lane_words
    leaf offset         = running word offset of the cache leaf (the
                          JAX package's flatten order: segments by
                          index, then sorted dict keys -- k, pos, v)
    layer stride        = words per layer of that leaf

so the whole lane migrates as ONE ``put_long_vectored`` whose
per-(leaf, layer) destination addresses ride inside the packet.

The port's cache is a list (one entry per layer segment) of dicts of
blocks of ``k`` / ``v`` ``(L, B, W, K, dh)`` and ``pos`` ``(L, B, W)``
leaves; a lane is axis 1.  Cache leaves are *value-cast* onto the
float32 segment words (bfloat16 -> float32 is exact, int32 ring
positions are exact below 2**24), never bitcast: an int bit pattern
read as a float could be a NaN that the egress mask arithmetic
changes.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core import ops
from repro_torch.core.address_space import GlobalAddressSpace
from repro_torch.core.state import PgasState

# credit token reserved for KV migrations (separate from app traffic so
# wait_replies on a migration never drains an application credit)
MIGRATE_TOKEN = 3


@dataclasses.dataclass(frozen=True)
class KvLeaf:
    """Layout of one cache leaf inside a lane's segment region."""

    path: str                     # "segment/block/name", e.g. 0/b0_dense/k
    layers: int                   # leading (layer) dim
    shape: tuple[int, ...]        # per-lane per-layer shape
    dtype: torch.dtype            # original leaf dtype
    words: int                    # words per layer (= layer stride)
    offset: int                   # word offset inside the lane region

    @property
    def total_words(self) -> int:
        return self.layers * self.words


def _flatten(cache) -> list[tuple[tuple, torch.Tensor]]:
    """``[((segment, block, name), leaf), ...]`` in the JAX package's
    flatten order: the segment list by index, then sorted dict keys."""
    return [((i, key, name), seg[key][name])
            for i, seg in enumerate(cache)
            for key in sorted(seg) for name in sorted(seg[key])]


def _path_str(path) -> str:
    return "/".join(str(p) for p in path)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).split(".")[-1]


class KvSegmentSpace:
    """Places ``lanes`` ring KV caches into PGAS segments.

    Every decode kernel uses the same layout over its own segment, so a
    prefill kernel computes a migration's destination addresses from
    ``lane`` alone.
    """

    def __init__(self, gas: GlobalAddressSpace, model, *, lanes: int,
                 slots: int):
        self.gas = gas
        self.ctx = gas.ctx
        self.lanes = int(lanes)
        self.slots = int(slots)
        flat = _flatten(model.make_cache(1, slots))
        if not flat:
            raise ValueError("model cache has no leaves to place in the "
                             "address space")
        leaves: list[KvLeaf] = []
        off = 0
        for path, leaf in flat:
            if leaf.dim() < 2 or leaf.shape[1] != 1:
                raise ValueError(
                    f"cache leaf {_path_str(path)} has shape "
                    f"{tuple(leaf.shape)}; expected (layers, lane, ...) "
                    "stacked cache state")
            words = math.prod(leaf.shape[2:]) if leaf.dim() > 2 else 1
            leaves.append(KvLeaf(
                path=_path_str(path), layers=int(leaf.shape[0]),
                shape=tuple(int(d) for d in leaf.shape[2:]),
                dtype=leaf.dtype, words=int(words), offset=off))
            off += int(leaf.shape[0]) * int(words)
        self._paths = tuple(path for path, _ in flat)
        self.leaves = tuple(leaves)
        self.lane_words = off
        need = self.lanes * self.lane_words
        if need > self.ctx.segment_words:
            raise ValueError(
                f"KvSegmentSpace needs {need} words ({self.lanes} lanes x "
                f"{self.lane_words} words/lane) but segments hold only "
                f"{self.ctx.segment_words}")
        if self.lane_words + self.n_blocks \
                > self.ctx.transport.max_packet_words:
            raise ValueError(
                f"one KV lane ({self.lane_words} payload words + "
                f"{self.n_blocks} vectored addresses) exceeds the transport "
                f"MTU ({self.ctx.transport.max_packet_words} words); "
                "vectored puts do not segment — shrink slots or raise "
                "max_packet_bytes")

    @property
    def n_blocks(self) -> int:
        """Blocks of one migration: one per (leaf, layer)."""
        return sum(leaf.layers for leaf in self.leaves)

    # -- addressing (Python ints) -------------------------------------------

    def lane_base(self, lane: int) -> int:
        if not 0 <= lane < self.lanes:
            raise ValueError(f"lane {lane} out of range ({self.lanes} lanes)")
        return lane * self.lane_words

    def block_addrs(self, lane: int, *, kernel: int = 0) -> list[int]:
        """Per-(leaf, layer) destination addresses for migrating one lane
        into ``kernel``'s segment -- the vectored address list that rides
        in-packet.  Validated against the owner's segment bounds."""
        base = self.lane_base(lane)
        addrs: list[int] = []
        for leaf in self.leaves:
            addrs.extend(self.gas.vectored_addrs(
                kernel, base + leaf.offset,
                [leaf.words] * leaf.layers, stride=leaf.words))
        return addrs

    # -- pack / unpack -------------------------------------------------------

    def pack_lane(self, lane_cache) -> list[torch.Tensor]:
        """Flatten a (B=1) lane cache into per-(leaf, layer) segment-word
        blocks, 1-D and ordered to match :meth:`block_addrs`."""
        flat = _flatten(lane_cache)
        paths = tuple(path for path, _ in flat)
        if paths != self._paths:
            raise ValueError(
                "lane cache structure does not match this KvSegmentSpace "
                f"layout: {[_path_str(p) for p in paths]} != "
                f"{[_path_str(p) for p in self._paths]}")
        blocks: list[torch.Tensor] = []
        for meta, (_, leaf) in zip(self.leaves, flat):
            rows = leaf.reshape(meta.layers, meta.words).to(self.gas.dtype)
            blocks.extend(rows.unbind(0))
        return blocks

    def unpack_lane(self, segment_row: torch.Tensor, lane: int):
        """Rebuild a (B=1) lane cache from one kernel's segment words (the
        decode side's view after a migration landed), on the row's
        device, each leaf in its own dtype (a leaf already in the
        segment's dtype is a view of the row)."""
        base = self.lane_base(lane)
        cache: list[dict] = []
        for (i, key, name), leaf in zip(self._paths, self.leaves):
            start = base + leaf.offset
            flat = segment_row[start:start + leaf.total_words]
            while len(cache) <= i:
                cache.append({})
            cache[i].setdefault(key, {})[name] = flat.reshape(
                (leaf.layers, 1) + leaf.shape).to(leaf.dtype)
        return cache

    # -- migration -----------------------------------------------------------

    def migrate(self, state: PgasState, blocks, pattern, lane: int, *,
                token: int = MIGRATE_TOKEN, wait: bool = True) -> PgasState:
        """One finished prefill's KV -> a decode lane, as ONE vectored put.

        ``pattern`` is the ``[(prefill_kernel, decode_kernel)]`` link and
        ``blocks`` the :meth:`pack_lane` output (1-D blocks stand for
        every kernel's, as the JAX package's replicated blocks do; or
        pass ``(K, w)`` blocks).  The per-layer destination address list
        rides in-packet.  On an acked transport the single coalesced
        reply is awaited on the migration token, so the decode side's
        adoption is ordered after the write.
        """
        dst = pattern[-1][1]
        addrs = self.block_addrs(lane, kernel=dst)
        K = self.ctx.num_kernels
        blocks = [b.reshape(1, -1).expand(K, -1) if b.dim() == 1 else b
                  for b in blocks]
        state = ops.put_long_vectored(self.ctx, state, blocks, pattern,
                                      addrs, token=token)
        if wait and self.ctx.transport.acked:
            # only the prefill side gets the reply; waiting for n=1 on
            # every kernel would raise the underflow bit on the rest
            n = ops._is_sender(self.ctx, pattern).to(torch.int32)
            state = ops.wait_replies(self.ctx, state, token=token, n=n)
        return state

    def describe(self) -> str:
        """Human-readable layout table."""
        lines = [f"lane_words={self.lane_words} lanes={self.lanes} "
                 f"segment_words={self.ctx.segment_words}"]
        for leaf in self.leaves:
            lines.append(
                f"  +{leaf.offset:<6} {leaf.path}: {leaf.layers} layers x "
                f"{leaf.words} words (shape {leaf.shape}, "
                f"{_dtype_name(leaf.dtype)})")
        return "\n".join(lines)
