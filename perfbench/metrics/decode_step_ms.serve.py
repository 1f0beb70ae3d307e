"""Milliseconds of a decode step over every lane: the serving engine's
``step`` (the model's step and the host's sampling), the mean over the
window's calls."""


def read(rec):
    if rec["kind"] != "serve" or not rec["calls"].get("decode"):
        return None
    return 1e3 * rec["spans"]["decode"] / rec["calls"]["decode"]
