"""Shoal exchanges (``ShoalContext.exchanges``: link traversals) a
training step makes, over the window: the shoal backend's gradient sync
or the expert-parallel island's collectives."""


def read(rec):
    if rec["kind"] != "train":
        return None
    return rec["exchanges_per_step"]
