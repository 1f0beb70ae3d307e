"""Faults planted in the program underneath the timed path, for the
checks' upper readings (``control.py``, on the card) and for the tests
that see ``correct`` come out false (on the CPU).  No benchmark run
plants one.

* ``unchanged``: a training step returns its state unchanged;
* ``half_batch``: half of each batch left out, the mean taken over the
  rest (training: the loss and gradient's rows; serving: the decode
  step's second half of the lanes gets no logits);
* ``no_exchange``: the ring all-reduce between the Shoal kernels left
  out (each kernel keeps its own addend);
* ``token``: every 16th token the serving engine samples altered.
"""

from __future__ import annotations

TRAIN = ("unchanged", "half_batch", "no_exchange")
SERVE = ("half_batch", "token")


def plant(name: str) -> None:
    from repro_torch.core import collectives as coll
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.training.train import Trainer

    if name == "unchanged":
        Trainer.apply_update = (
            lambda self, state, grads, loss, ef_residual=None:
            (state, {"loss": loss}))
    elif name == "half_batch":
        vag, dec = Trainer.value_and_grad, Model.decode_step

        def value_and_grad(self, params, batch):
            rows = next(iter(batch.values())).shape[0]
            return vag(self, params, {k: v[:max(rows // 2, 1)]
                                      for k, v in batch.items()})

        def decode_step(self, params, cache, token, pos, image_feats=None):
            logits, cache = dec(self, params, cache, token, pos, image_feats)
            logits[logits.shape[0] // 2:] = 0
            return logits, cache

        Trainer.value_and_grad = value_and_grad
        Model.decode_step = decode_step
    elif name == "no_exchange":
        coll.ring_all_reduce = lambda ctx, x: x
    elif name == "token":
        sample = ServeEngine._sample
        count = [0]

        def altered(self, logits):
            tok = sample(self, logits)
            count[0] += 1
            return (tok + 1) % len(logits) if count[0] % 16 == 0 else tok

        ServeEngine._sample = altered
    else:
        raise KeyError(f"unknown fault {name!r}")
