"""Serving of the port: the lane-batched ``ServeEngine``.  The KV space,
the disaggregated tier and the front end wait for the next slice
(ROADMAP queue 1 item 12)."""

from repro_torch.serving.engine import (Request, ServeEngine, lane_slice,
                                        lane_write, reset_lane)

__all__ = ["ServeEngine", "Request", "lane_slice", "lane_write",
           "reset_lane"]
