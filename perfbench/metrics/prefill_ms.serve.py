"""Milliseconds of a prefill: the serving engine's ``submit`` (the lane's
reset, the prompt pass and the first token's sampling), the mean over
the window's calls."""


def read(rec):
    if rec["kind"] != "serve" or not rec["calls"].get("prefill"):
        return None
    return 1e3 * rec["spans"]["prefill"] / rec["calls"]["prefill"]
