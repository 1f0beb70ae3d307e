"""Serving engine: batched prefill + decode with slot management (the
port of ``repro.serving.engine``).

The decode step runs over a fixed batch of *lanes*; requests are
multiplexed onto free lanes (continuous-batching style).  Each lane
tracks its own absolute position, so mixed-progress lanes decode
together in one step -- ring caches and the position-masked attention
make this correct (slots whose ``pos`` is -1 never attend).

The lane axis is axis 1 of every stacked cache leaf, ``(L, B, W, K,
dh)`` (MLA's latent leaves: ``(L, B, W, C)``; the RG-LRU state: ``h``
``(L, B, dr)`` and ``conv`` ``(L, B, W - 1, dr)``; the mLSTM's ``C``
``(L, B, nh, dh, dh)``, the sLSTM's ``h`` ``(L, B, d)``).  The
lane-cache helpers (:func:`lane_slice`, :func:`lane_write`,
:func:`reset_lane`) are module-level, as in the JAX package.  Where the
JAX package builds new caches, the port works in place: a lane slice is
a view, a prefill writes its lane through it, a reset clears the lane.
Sampling stays on the host with numpy, as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.actors.events import EventMailbox, SlotEvent
from repro_torch.models.model import Model


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # (S,) int32
    max_new: int
    out: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


# --------------------------------------------------------------------------
# lane-cache plumbing
# --------------------------------------------------------------------------

def lane_slice(cache, lane: int):
    """One lane's cache (B=1 on axis 1) as views into the full cache."""
    return [{key: {name: c.narrow(1, lane, 1) for name, c in blk.items()}
             for key, blk in seg.items()} for seg in cache]


def lane_write(cache, lane_cache, lane: int):
    """Copy a (B=1) lane cache into the full cache at ``lane``."""
    for seg, lane_seg in zip(cache, lane_cache):
        for key, blk in seg.items():
            for name, full in blk.items():
                full.narrow(1, lane, 1).copy_(lane_seg[key][name])
    return cache


def reset_lane(cache, lane: int):
    """Clear a lane's cache before reuse, in place, as the JAX engine
    does: position slots to -1 (so the masked attention ignores them),
    every stabilizer ``m`` to -30 (the mLSTM's fresh value; the sLSTM's
    is -1e30, which the JAX engine's reset also writes as -30), every
    other leaf to 0 (GQA's k / v, MLA's ckv / kr, the RG-LRU state h /
    conv and the xLSTM states, whose JAX init is zeros)."""
    fill = {"pos": -1, "m": -30.0}
    for seg in cache:
        for blk in seg.values():
            for name, c in blk.items():
                c.narrow(1, lane, 1).fill_(fill.get(name, 0))
    return cache


class ServeEngine:
    def __init__(self, model: Model, params, lanes: int, slots: int,
                 greedy: bool = True, temperature: float = 1.0, seed: int = 0,
                 event_sink=None, event_watermark: int = 64):
        self.model = model
        self.params = params
        self.lanes = lanes
        self.slots = slots
        self.greedy = greedy
        self.temperature = temperature
        self.rng = np.random.default_rng(seed)
        # slot accounting goes through a mailbox: acquire/release events
        # batch up and reach event_sink once per decode step (phase
        # boundary), not once per lane transition
        self.events = EventMailbox(watermark=event_watermark,
                                   sink=event_sink)

        self.device = model.device
        self.cache = model.make_cache(lanes, slots)
        self.pos = np.zeros((lanes,), np.int32)
        self.last_tok = np.zeros((lanes,), np.int32)
        self.active: list[Request | None] = [None] * lanes

    # -- lane-granular prefill ------------------------------------------------

    def _prefill_lane(self, tokens, lane: int):
        """Run a (1, S) prompt, writing its cache into lane ``lane``."""
        logits, _ = self.model.prefill(self.params, {"tokens": tokens},
                                       lane_slice(self.cache, lane))
        return logits

    # -- scheduling -----------------------------------------------------------

    def find_free_lane(self) -> int | None:
        """Lowest free lane index, or None when saturated."""
        for lane, cur in enumerate(self.active):
            if cur is None:
                return lane
        return None

    def submit(self, req: Request) -> bool:
        """Place a request on a free lane (prefill now).  False if full."""
        lane = self.find_free_lane()
        if lane is None:
            return False
        reset_lane(self.cache, lane)
        self.active[lane] = req
        toks = torch.as_tensor(np.asarray(req.prompt, np.int64),
                               device=self.device)[None]
        logits = self._prefill_lane(toks, lane)
        tok = self._sample(logits[0].float().cpu().numpy())
        req.out.append(int(tok))
        self.pos[lane] = len(req.prompt)
        self.last_tok[lane] = tok
        self.events.send(SlotEvent("acquire", lane, req.rid))
        return True

    def adopt_lane(self, lane: int, lane_cache, req: Request, *,
                   pos: int, last_tok: int) -> None:
        """Attach an externally prefilled request to ``lane``.

        ``lane_cache`` is a (B=1) cache tree.  The lane is NOT reset
        first: adoption overwrites every cache leaf.
        """
        if self.active[lane] is not None:
            raise ValueError(f"adopt_lane: lane {lane} is busy "
                             f"(rid={self.active[lane].rid})")
        lane_write(self.cache, lane_cache, lane)
        self.active[lane] = req
        self.pos[lane] = pos
        self.last_tok[lane] = last_tok
        self.events.send(SlotEvent("acquire", lane, req.rid))

    def _sample(self, logits: np.ndarray) -> int:
        if self.greedy:
            return int(np.argmax(logits))
        p = np.exp((logits - logits.max()) / self.temperature)
        p /= p.sum()
        return int(self.rng.choice(len(p), p=p))

    def step(self):
        """One decode step for all active lanes."""
        if not any(r is not None and not r.done for r in self.active):
            return
        toks = torch.as_tensor(self.last_tok.astype(np.int64),
                               device=self.device)[:, None]
        pos = torch.as_tensor(self.pos.astype(np.int64), device=self.device)
        logits, _ = self.model.decode_step(self.params, self.cache, toks, pos)
        logits = logits.float().cpu().numpy()
        for lane, req in enumerate(self.active):
            if req is None or req.done:
                continue
            tok = self._sample(logits[lane])
            req.out.append(tok)
            self.pos[lane] += 1
            self.last_tok[lane] = tok
            if len(req.out) >= req.max_new:
                req.done = True
                self.active[lane] = None
                self.events.send(SlotEvent("release", lane, req.rid))
        # phase boundary: this step's slot events go out as one batch
        self.events.flush()

    @property
    def idle(self) -> bool:
        return all(r is None for r in self.active)

    def drain(self):
        """Force-deliver pending slot events when the request stream ends
        (a final ``submit`` whose acquire never met another step).
        Returns the final delivered batch."""
        return self.events.flush()

    def run(self, requests: list[Request]) -> list[Request]:
        """Serve a request list to completion (simple FCFS scheduler)."""
        pending = list(requests)
        done: list[Request] = []
        while pending or any(r is not None for r in self.active):
            while pending and self.submit(pending[0]):
                pending.pop(0)
            self.step()
            for r in requests:
                if r.done and r not in done:
                    done.append(r)
        self.drain()
        return done
