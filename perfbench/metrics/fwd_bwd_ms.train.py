"""Milliseconds a training step spends in the model's forward and backward
(``Trainer.value_and_grad``, every member's under the shoal backend), timed
between device synchronisations over the traced run's span steps."""


def read(rec):
    if rec["kind"] != "train" or "fwd_bwd" not in rec["spans"]:
        return None
    return 1e3 * rec["spans"]["fwd_bwd"] / rec["span_steps"]
