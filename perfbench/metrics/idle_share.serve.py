"""The share of the profiled serving sub-window in which no activity ran
on the device, in percent."""


def read(rec):
    if rec["kind"] != "serve" or not rec["profile"]["busy_s"]:
        return None
    p = rec["profile"]
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
