"""The training window's model FLOPs (``flops.train_step_flops``: no
recomputation, no capacity padding) over its length and the card's
peak for the configuration's dtype, in percent."""

from perfbench import flops


def read(rec):
    if rec["platform"] != "cuda" or rec["kind"] != "train":
        return None
    return flops.share_of_peak(rec["window_flops"], rec["window_s"],
                               rec["dtype"])
