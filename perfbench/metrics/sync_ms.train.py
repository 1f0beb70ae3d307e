"""Milliseconds a training step spends in the shoal backend's gradient sync
(``Trainer.sync``); none under a backend without one, timed
between device synchronisations over the traced run's span steps."""


def read(rec):
    if rec["kind"] != "train" or "sync" not in rec["spans"]:
        return None
    return 1e3 * rec["spans"]["sync"] / rec["span_steps"]
