"""Serving of the port: the lane-batched ``ServeEngine``, KV caches as
PGAS segments, the disaggregated prefill/decode tier and its admission
front end (the port of ``repro.serving``)."""

from repro_torch.serving.engine import (Request, ServeEngine, lane_slice,
                                        lane_write, reset_lane)
from repro_torch.serving.frontend import (DONE, QUEUED, REJECTED, RUNNING,
                                          Job, ServeFrontend)
from repro_torch.serving.kv_space import MIGRATE_TOKEN, KvSegmentSpace

__all__ = [
    "ServeEngine", "Request", "lane_slice", "lane_write", "reset_lane",
    "ServeFrontend", "Job", "QUEUED", "RUNNING", "DONE", "REJECTED",
    "KvSegmentSpace", "MIGRATE_TOKEN",
]


def __getattr__(name):
    # the tier pulls in the launch slices and the core ops; import it
    # lazily so `from repro_torch.serving import ServeEngine` stays light
    if name in ("DisaggServeTier", "PrefillWorker"):
        from repro_torch.serving import disagg

        return getattr(disagg, name)
    raise AttributeError(name)
