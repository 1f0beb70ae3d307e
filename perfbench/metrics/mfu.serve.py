"""The serving window's model FLOPs (each prefill's and each decode
step's useful work: ``flops.prefill_flops``, ``flops.decode_flops``)
over its length and the card's peak for the configuration's dtype, in
percent."""

from perfbench import flops


def read(rec):
    if rec["platform"] != "cuda" or rec["kind"] != "serve":
        return None
    return flops.share_of_peak(rec["window_flops"], rec["window_s"],
                               rec["dtype"])
