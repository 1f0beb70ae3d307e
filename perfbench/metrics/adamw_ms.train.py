"""Milliseconds a training step spends in the AdamW update
(``Trainer.apply_update``), timed
between device synchronisations over the traced run's span steps."""


def read(rec):
    if rec["kind"] != "train" or "adamw" not in rec["spans"]:
        return None
    return 1e3 * rec["spans"]["adamw"] / rec["span_steps"]
