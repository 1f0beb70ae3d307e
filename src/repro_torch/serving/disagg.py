"""Disaggregated serving tier: prefill and decode on disjoint kernel sets
(the port of ``repro.serving.disagg``).

The lane-batched :class:`~repro_torch.serving.engine.ServeEngine`
interleaves prefill and decode; at scale a long prompt stalls every
decoding lane.  The disaggregated tier splits the kernel axis into a
prefill slice and a decode slice (:class:`repro_torch.launch.mesh.
ServingSlices`) and moves a finished prefill's KV to a free decode lane
as ONE one-sided ``put_long_vectored`` into the decode kernel's PGAS
segment (:class:`~repro_torch.serving.kv_space.KvSegmentSpace` fixes
the per-lane, per-layer layout).  On one card the kernels are rows of
the leading kernel axis: a migration is a plain call, two exchanges
when acked (the fused vectored packet and the coalesced reply), which
``ctx.exchanges`` counts.

Bit-identity contract: a migrated request decodes to exactly the tokens
the lane-batched engine produces, because the prefill workers run the
engine's own ``reset_lane`` + ``lane_slice`` + ``model.prefill`` path
and the segment round trip is value-exact.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch

from repro_torch.core.address_space import GlobalAddressSpace
from repro_torch.core.state import ShoalContext
from repro_torch.launch.mesh import ServingSlices
from repro_torch.runtime.transport import TCP
from repro_torch.serving.engine import (Request, ServeEngine, lane_slice,
                                        reset_lane)
from repro_torch.serving.kv_space import MIGRATE_TOKEN, KvSegmentSpace


class PrefillWorker:
    """One prefill kernel: ragged-prompt prefill into its own one-lane
    cache, reset in place before every prompt (so the prompt pass takes
    the flash kernel, as the engine's does)."""

    def __init__(self, model, params, slots: int, kernel_id: int):
        self.model = model
        self.params = params
        self.kernel_id = kernel_id
        self.cache = model.make_cache(1, slots)
        self.prefills = 0

    def prefill(self, prompt: np.ndarray):
        """Returns ``(last_logits (vocab,), lane_cache)`` for one prompt;
        ``lane_cache`` views the worker's cache until its next prompt."""
        reset_lane(self.cache, 0)
        toks = torch.as_tensor(np.asarray(prompt, np.int64),
                               device=self.model.device)[None]
        logits, lane_cache = self.model.prefill(
            self.params, {"tokens": toks}, lane_slice(self.cache, 0))
        self.prefills += 1
        return logits[0], lane_cache


class DisaggServeTier:
    """Prefill slice + PGAS KV migration + decode slice.

    Duck-types the :class:`ServeEngine` scheduler surface (``submit`` /
    ``step`` / ``drain`` / ``idle`` / ``run``) so the admission front
    end (:mod:`repro_torch.serving.frontend`) drives either.  The
    context lives on ``device`` (default: the CUDA card), which must be
    the model's.
    """

    def __init__(self, model, params, slices: ServingSlices, *,
                 lanes_per_decode: int, slots: int, transport=TCP,
                 segment_words: int | None = None, greedy: bool = True,
                 seed: int = 0, event_sink=None, device=None):
        self.model = model
        self.params = params
        self.slices = slices
        if segment_words is None:
            segment_words = lanes_per_decode * _lane_words(model, slots)
        self.ctx = ShoalContext(slices.num_kernels, transport,
                                segment_words, device=device)
        if self.ctx.device.type != model.device.type:
            raise ValueError(f"DisaggServeTier: context on {self.ctx.device}"
                             f", model on {model.device}")
        self.gas = GlobalAddressSpace(self.ctx)
        self.kv = KvSegmentSpace(self.gas, model, lanes=lanes_per_decode,
                                 slots=slots)
        self.state = self.gas.make_global_state()
        self.workers = {pid: PrefillWorker(model, params, slots, pid)
                        for pid in slices.prefill_ids}
        self._next_prefill = itertools.cycle(slices.prefill_ids)
        self.engines = {
            did: ServeEngine(model, params, lanes=lanes_per_decode,
                             slots=slots, greedy=greedy, seed=seed + did,
                             event_sink=event_sink)
            for did in slices.decode_ids}
        self.migrations = 0

    # -- migration ------------------------------------------------------------

    def migrate(self, src: int, dst: int, lane: int, lane_cache):
        """ONE one-sided vectored put: ``src``'s finished lane cache into
        lane ``lane`` of decode kernel ``dst``'s segment.  Returns the
        decode side's view of the lane, rebuilt from that segment row on
        the device."""
        pattern = self.slices.migration_pattern(src, dst)
        blocks = self.kv.pack_lane(lane_cache)
        self.state = self.kv.migrate(self.state, blocks, pattern, lane,
                                     token=MIGRATE_TOKEN)
        self.migrations += 1
        return self.kv.unpack_lane(self.state.segment[dst], lane)

    # -- scheduling (ServeEngine duck type) ------------------------------------

    @property
    def active(self):
        return [r for eng in self.engines.values() for r in eng.active]

    @property
    def idle(self) -> bool:
        return all(eng.idle for eng in self.engines.values())

    def find_free_lane(self):
        for did, eng in self.engines.items():
            lane = eng.find_free_lane()
            if lane is not None:
                return did, lane
        return None

    def submit(self, req: Request) -> bool:
        """Prefill on the prefill slice, migrate KV, adopt on decode.

        False when every decode lane is busy (the front end's
        backpressure signal)."""
        slot = self.find_free_lane()
        if slot is None:
            return False
        did, lane = slot
        src = next(self._next_prefill)
        logits, lane_cache = self.workers[src].prefill(req.prompt)
        eng = self.engines[did]
        tok = eng._sample(logits.float().cpu().numpy())
        adopted = self.migrate(src, did, lane, lane_cache)
        req.out.append(int(tok))
        eng.adopt_lane(lane, adopted, req, pos=len(req.prompt),
                       last_tok=int(tok))
        return True

    def step(self):
        for eng in self.engines.values():
            eng.step()

    def drain(self):
        out = []
        for eng in self.engines.values():
            out.extend(eng.drain())
        return out

    def run(self, requests: list[Request]) -> list[Request]:
        """FCFS to completion -- the lane-batched engine's scheduler
        loop, so token outputs are comparable request for request."""
        pending = list(requests)
        done: list[Request] = []
        while pending or not self.idle:
            while pending and self.submit(pending[0]):
                pending.pop(0)
            self.step()
            for r in requests:
                if r.done and r not in done:
                    done.append(r)
        self.drain()
        return done


def _lane_words(model, slots: int) -> int:
    """Words one lane's cache occupies in a segment (layout probe)."""
    total = 0
    for seg in model.make_cache(1, slots):
        for blk in seg.values():
            for leaf in blk.values():
                if leaf.dim() < 2:
                    raise ValueError("cache leaf with no lane dim")
                total += leaf.shape[0] * math.prod(leaf.shape[2:])
    return total
