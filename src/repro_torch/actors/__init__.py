"""Actor layer: per-destination small-message aggregation over Shoal AMs.

The paper's PGAS model pays one network transaction per active message,
which is ruinous for header-sized control traffic (MoE routing metadata,
credit returns, serve-engine slot events).  Mailboxes append tiny
messages into a per-destination packet stack -- the ``(K, n, HDR+W)``
fused wire format of >MTU segmentation -- and flush the whole stack as
ONE exchange on a watermark or an explicit phase boundary.

* :class:`~repro_torch.actors.mailbox.Mailbox` -- N tiny Short/Long AMs
  to one destination cost one exchange (plus, on an acked transport,
  one reply for the whole flush).
* :class:`~repro_torch.actors.mailbox.MultiMailbox` -- one mailbox over
  several destination patterns: sub-stacks of patterns with disjoint
  source/destination sets flush as one exchange per group, with one
  counted reply per group.
* :class:`~repro_torch.actors.mailbox.ReplyMailbox` -- defers the
  auto-replies of ordinary puts (``reply_via=``) and returns all owed
  credits per destination as one Short AM.
* :class:`~repro_torch.actors.events.EventMailbox` -- host-side
  equivalent for control-plane events (serve-engine slot accounting).
* :mod:`~repro_torch.actors.coalesce` -- bit-exact metadata-lane packing.
"""

from repro_torch.actors.coalesce import pack_meta_lane, unpack_meta_lane
from repro_torch.actors.events import EventMailbox, SlotEvent
from repro_torch.actors.mailbox import Mailbox, MultiMailbox, ReplyMailbox

__all__ = [
    "Mailbox",
    "MultiMailbox",
    "ReplyMailbox",
    "EventMailbox",
    "SlotEvent",
    "pack_meta_lane",
    "unpack_meta_lane",
]
