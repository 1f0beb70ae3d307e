"""The training driver: the program's ``Trainer.step`` on batches drawn
from the seed, one step after another, for the window.

Set-up builds one trainer and its state from the seed's weights and
drives it through the mix's ``checked_steps`` first steps, on the
window's own call and feed; those steps warm every shape the window
runs.  Their losses, the first gradient as the optimizer got it (its
first moment after one step, over ``1 - b1``) and the parameters'
change over them are the program's side of the check.  The same
trainer and state then run the window.  After it (and, in a traced
run, a few steps timed by layer and one profiled step) the program's
state is freed and the reference follows the same steps in float32
from the same draws.

Mix keys: ``backend`` (``xla`` | ``shoal``), ``shoal_kernels`` (the
shoal backend's data-parallel members), ``expert_kernels`` (an
``ExpertMesh`` of that many kernels for the MoE layers, 0 for none),
``rows`` and ``seq`` (a step's batch), ``donate``, ``optimizer`` (the
AdamW settings), ``checked_steps``, ``span_steps``, ``profile_steps``.
"""

from __future__ import annotations

import gc
import math
import time

import torch

from perfbench import bench, flops, weights
from perfbench.reference import adamw


class Feed:
    """Token rows drawn on the device from the seed, ``rows x (seq + 1)``
    a step, uniform over the vocabulary; every row differs."""

    def __init__(self, seed: int, mix: dict, vocab: int, device):
        self.gen = torch.Generator(device=device).manual_seed(
            weights.batch_seed(seed))
        self.shape = (mix["rows"], mix["seq"] + 1)
        self.vocab, self.device = vocab, device

    def next(self) -> dict:
        t = torch.randint(0, self.vocab, self.shape, generator=self.gen,
                          device=self.device)
        return {"tokens": t[:, :-1], "labels": t[:, 1:]}


def _diff_norm(a, b, chunk: int = 1 << 26) -> float:
    """``||a - b||`` in float32, a chunk of words at a time."""
    a, b = a.reshape(-1), b.reshape(-1)
    total = torch.zeros((), dtype=torch.float32, device=a.device)
    for lo in range(0, a.numel(), chunk):
        total += (a[lo:lo + chunk].float()
                  - b[lo:lo + chunk].float()).square().sum()
    return total.sqrt().item()


def change_norms(cell, current: dict, seed: int, device) -> dict:
    """Every leaf's ``||p - p0||``, the start drawn again leaf by leaf."""
    m = cell.config["model"]
    specs = bench.family_module(cell, "reference").leaf_specs(m)
    return {name: _diff_norm(current[name], p0) for name, p0 in
            weights.iter_draw(specs, seed, device,
                              weights.DTYPES[m["dtype"]])}


def sample(cell, seed: int, device) -> dict:
    """Every leaf's sampled positions (``weights.sample_index``)."""
    specs = bench.family_module(cell, "reference").leaf_specs(
        cell.config["model"])
    return {name: weights.sample_index(seed, i, math.prod(shape), device)
            for i, (name, shape, _) in enumerate(specs)}


def build(cell, device):
    """The program's trainer for the cell, and the context whose
    exchanges the step makes."""
    from repro_torch.core.state import ShoalContext
    from repro_torch.models.model import build_model
    from repro_torch.models.moe import ExpertMesh
    from repro_torch.optim import AdamWConfig
    from repro_torch.training import Trainer, TrainerConfig

    mix = cell.mix
    ep = (ExpertMesh(ShoalContext(mix["expert_kernels"], device=device))
          if mix["expert_kernels"] else None)
    model = build_model(bench.port_config(cell.config), device=device, ep=ep)
    tr = Trainer(model, AdamWConfig(**mix["optimizer"]),
                 TrainerConfig(comm_backend=mix["backend"],
                               donate=mix["donate"]),
                 kernels=mix["shoal_kernels"])
    return tr, (tr.ctx if tr.ctx is not None else ep.ctx if ep else None)


def program(cell, seed: int, device, phases=None):
    """Set-up: the trainer, its state after the checked steps, the feed,
    and the program's readings of those steps."""
    phases = phases or bench.Phases(time.time())
    m, mix = cell.config["model"], cell.mix
    layout = bench.family_module(cell, "layouts")
    specs = bench.family_module(cell, "reference").leaf_specs(m)
    tr, ctx = build(cell, device)
    state = tr.state_for(layout.port_tree(m, weights.draw(
        specs, seed, device, weights.DTYPES[m["dtype"]])))
    feed = Feed(seed, mix, m["vocab"], device)
    bench.sync(device)
    phases.mark("build_and_draw")
    b1 = mix["optimizer"]["b1"]
    losses, grad_norms = [], None
    for i in range(mix["checked_steps"]):
        state, met = tr.step(state, feed.next())
        losses.append(met["loss"].item())
        if i == 0:
            first = layout.named(m, state.opt_state["m"])
            grad_norms = {n: t.norm().item() / (1 - b1)
                          for n, t in first.items()}
            grad_sample = {n: first[n].reshape(-1)[idx] / (1 - b1)
                           for n, idx in sample(cell, seed, device).items()}
            del first
    phases.mark("checked_steps")
    change = change_norms(cell, layout.named(m, state.params), seed, device)
    phases.mark("change_norms")
    return (tr, ctx, state, feed), {"losses": losses,
                                    "grad_norms": grad_norms,
                                    "grad_sample": grad_sample,
                                    "change": change}


def reference(cell, seed: int, device, prec: str = "float32") -> dict:
    """The reference's readings of the checked steps: the same draws and
    batches, float32 parameters (or the control's ``fp8`` products)."""
    m, mix = cell.config["model"], cell.mix
    ref = bench.family_module(cell, "reference")
    specs = ref.leaf_specs(m)
    dtype = weights.DTYPES[m["dtype"]]
    p = {n: t.float() for n, t in weights.iter_draw(specs, seed, device,
                                                     dtype)}
    feed = Feed(seed, mix, m["vocab"], device)
    batches = [feed.next() for _ in range(mix["checked_steps"])]

    def grad_fn(params, i):
        return ref.loss_and_grads(params, batches[i]["tokens"],
                                  batches[i]["labels"], m, prec)

    idx, got = sample(cell, seed, device), {}

    def watch(name, g):
        got[name] = g.reshape(-1)[idx[name]]

    with ref.exact_matmuls():
        out = adamw.run(p, grad_fn, mix["checked_steps"], mix["optimizer"],
                        watch)
    out["grad_sample"] = got
    out["change"] = change_norms(cell, p, seed, device)
    return out


def compare(prog: dict, ref: dict, limits: dict) -> tuple[dict, dict]:
    """The checks ``{name: {value, limit}}`` of the numbers the cell's
    ``limits`` compare, and the rest: the leaf each is worst at, and the
    numbers not compared.  ``grad_err`` is the first gradient's relative
    error over each leaf's sampled positions.  The change and
    ``grad_err`` leave out leaves whose reference gradient is under a
    thousandth of the median leaf's: Adam moves those by round-off, and
    their gradient is round-off."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                    ref["losses"]))
    grad, grad_at = bench.relative_gaps(prog["grad_norms"],
                                        ref["grad_norms"])
    med = bench.quantile(list(ref["grad_norms"].values()), 0.5)
    moved = [n for n, g in ref["grad_norms"].items() if g >= 1e-3 * med]
    change, change_at = bench.relative_gaps(prog["change"], ref["change"],
                                            moved)
    errs = {n: ((prog["grad_sample"][n] - ref["grad_sample"][n]).norm()
                / ref["grad_sample"][n].norm().clamp(min=1e-30)).item()
            for n in moved}
    err_at = max(errs, key=errs.get)
    values = {"loss_gap": loss, "grad_gap": grad, "change_gap": change,
              "grad_err": errs[err_at]}
    info = {"grad_gap_leaf": grad_at, "change_gap_leaf": change_at,
            "grad_err_leaf": err_at}
    info.update({k: v for k, v in values.items() if k not in limits})
    return ({k: {"value": v, "limit": limits[k]} for k, v in values.items()
             if k in limits}, info)


def _free(device) -> None:
    gc.collect()
    bench.sync(device)
    if device.type == "cuda":
        torch.cuda.empty_cache()


def run(ctx) -> dict:
    cell, device, mix = ctx.cell, ctx.device, ctx.cell.mix
    m = cell.config["model"]
    phases = bench.Phases(ctx.t_start)
    (tr, shoal, state, feed), prog = program(cell, ctx.seed, device, phases)
    probe = bench.Probe(device)
    if ctx.trace:
        probe.wrap(tr, "value_and_grad", "fwd_bwd")
        probe.wrap(tr, "sync", "sync")
        probe.wrap(tr, "apply_update", "adamw")
    bench.sync(device)
    setup_s = time.time() - ctx.t_start

    # the window
    ex0 = shoal.exchanges if shoal else 0
    losses, steps = [], 0
    t0 = time.perf_counter()
    while True:
        state, met = tr.step(state, feed.next())
        losses.append(met["loss"])
        steps += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    bench.sync(device)
    window = time.perf_counter() - t0
    phases.mark("window")
    exchanges = (shoal.exchanges - ex0) if shoal else 0
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    tokens = mix["rows"] * mix["seq"]
    out = {"end_to_end": {"train_tokens_per_s": steps * tokens / window,
                          "setup_s": setup_s},
           "attempted": steps, "failed": failed}

    if ctx.trace:
        probe.timing = True
        for _ in range(mix["span_steps"]):
            state, _ = tr.step(state, feed.next())
        probe.timing = False
        ring = RingBytes()

        def profiled():
            nonlocal state
            for _ in range(mix["profile_steps"]):
                state, _ = tr.step(state, feed.next())

        probe.labels = True
        with ring:
            prof = bench.profile(profiled, device)
        out["profile"] = prof
        phases.mark("spans_and_profile")
        out["record"] = {
            "kind": "train", "platform": device.type, "dtype": m["dtype"],
            "window_s": window,
            "window_flops": steps * flops.train_step_flops(
                m, mix["rows"], mix["seq"]),
            "spans": probe.seconds, "span_steps": mix["span_steps"],
            "exchanges_per_step": exchanges / steps if shoal else None,
            "profile": prof, "ring_bytes": ring.bytes}
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                if device.type == "cuda" else 0)
    del tr, state, feed, shoal
    _free(device)
    ref = reference(cell, ctx.seed, device)
    phases.mark("reference")
    out["checks"], out["worst"] = compare(prog, ref, cell.checks["limits"])
    out["phases"] = phases.seconds
    return out


class RingBytes:
    """Bytes of every ring launch while active: the program's collectives
    call ``core.collectives.ring_collective`` once a launch."""

    def __init__(self):
        self.bytes = 0

    def __enter__(self):
        from repro_torch.core import collectives as coll

        self._coll, self._fn = coll, coll.ring_collective

        def counted(x, schedule):
            y = self._fn(x, schedule)
            self.bytes += flops.ring_bytes(x.nbytes, y.nbytes)
            return y

        coll.ring_collective = counted
        return self

    def __exit__(self, *exc):
        self._coll.ring_collective = self._fn
        return False
