"""The serving driver: closed-loop clients through the program's
``ServeFrontend`` over a ``ServeEngine``, greedy.

Each of the mix's ``clients`` sends its next request as soon as its
last one has finished (callers that each wait for a reply).  Request
sizes come from a fixed pool -- prompt lengths log-uniform over
``prompt_min``..``prompt_max``, output lengths uniform over
``new_min``..``new_max``, drawn from ``pool_seed`` -- that every seed
takes in its own order; the prompts' tokens are drawn from the seed.

Set-up: the weights from the seed, then ``warmup_steps`` scheduler
turns of the same loop (every client's first request admitted at once,
then the loop settles), which warm the shapes the window serves.  The
window runs the loop for ``--seconds``; requests sent in it are the
attempted ones.  After it no client sends again and the loop runs until
every request has finished.  Times are taken at the end of the
program's calls, each of which ends by copying its logits to the host:
a request's first token at the end of the ``submit`` that prefilled
it, every later token at the end of the decode ``step`` that made it.

The check: a sample of the window's finished requests drawn from the
seed, the one with the most tokens among them, until ``check_tokens``
served tokens; the reference runs once over each prompt and its served
tokens, and the widest gap by which a served token's logit lies below
the reference's best is compared.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from perfbench import bench, flops, weights


def pool_sizes(mix: dict) -> np.ndarray:
    """``(prompt_len, new_tokens)`` of the pool, from ``pool_seed``."""
    rng = np.random.default_rng(mix["pool_seed"])
    n = mix["pool"]
    lo, hi = np.log(mix["prompt_min"]), np.log(mix["prompt_max"])
    prompt = np.rint(np.exp(rng.uniform(lo, hi, n))).astype(int)
    new = rng.integers(mix["new_min"], mix["new_max"] + 1, n)
    return np.stack([prompt, new], axis=1)


class Requests:
    """The seed's request stream: the pool in the seed's order, prompts
    uniform over the vocabulary."""

    def __init__(self, mix: dict, seed: int, vocab: int):
        self.sizes = pool_sizes(mix)
        self.rng = np.random.default_rng(seed % (1 << 63))
        self.order = self.rng.permutation(len(self.sizes))
        self.vocab, self.i = vocab, 0

    def next(self):
        S, new = self.sizes[self.order[self.i % len(self.order)]]
        self.i += 1
        return self.rng.integers(0, self.vocab, int(S)).astype(np.int32), \
            int(new)


class Loop:
    """The closed loop over a frontend, and what it observed: each
    request's send time, token times and flops done, by rid."""

    def __init__(self, fe, engine, requests: Requests, model_cfg: dict):
        self.fe, self.engine, self.requests = fe, engine, requests
        self.m = model_cfg
        self.sent: dict[int, float] = {}
        self.times: dict[int, list] = {}
        self.prompts: dict[int, np.ndarray] = {}
        self.running: dict[int, object] = {}
        self.finished: list[int] = []
        self.work: list[tuple[float, int]] = []      # (time, model flops)
        self.sending = True
        submit, step = engine.submit, engine.step

        def timed_submit(req):
            ok = submit(req)
            if ok:
                t = time.perf_counter()
                self.times[req.rid] = [t] * len(req.out)
                self.running[req.rid] = req
                self.work.append((t, flops.prefill_flops(
                    self.m, len(req.prompt))))
            return ok

        def timed_step():
            pos = [int(engine.pos[lane]) for lane, r in
                   enumerate(engine.active) if r is not None and not r.done]
            step()
            t = time.perf_counter()
            if pos:
                self.work.append((t, flops.decode_flops(self.m, pos)))
            for rid, req in list(self.running.items()):
                got = self.times[rid]
                got += [t] * (len(req.out) - len(got))
                if req.done:
                    del self.running[rid]
                    self.finished.append(rid)

        engine.submit, engine.step = timed_submit, timed_step

    def send(self) -> None:
        prompt, new = self.requests.next()
        t = time.perf_counter()
        job = self.fe.submit(prompt, new)
        self.sent[job.rid] = t
        self.prompts[job.rid] = prompt
        if job.status == "rejected":    # counted failed; the client sends on
            self.finished.append(job.rid)

    def turn(self) -> None:
        """One scheduler turn; each client whose request finished in it
        sends its next one."""
        self.fe.pump()
        done, self.finished = self.finished, []
        if self.sending:
            for _ in done:
                self.send()

    def busy(self) -> bool:
        return bool(self.running) or self.fe.queue_depth > 0


def build(cell, seed: int, device):
    """The program's engine and frontend over the seed's weights."""
    from repro_torch.models.model import build_model
    from repro_torch.serving import ServeEngine, ServeFrontend

    m, mix = cell.config["model"], cell.mix
    model = build_model(bench.port_config(cell.config), device=device)
    specs = bench.family_module(cell, "reference").leaf_specs(m)
    params = bench.family_module(cell, "layouts").port_tree(
        m, weights.draw(specs, seed, device, weights.DTYPES[m["dtype"]]))
    engine = ServeEngine(model, params, lanes=mix["lanes"],
                         slots=mix["slots"], greedy=True)
    return engine, ServeFrontend(engine, max_queue=mix["clients"])


def start(cell, seed: int, device, phases=None) -> Loop:
    """Set-up: the engine, the loop, every client's first request, and
    the warm-up turns."""
    phases = phases or bench.Phases(time.time())
    engine, fe = build(cell, seed, device)
    bench.sync(device)
    phases.mark("build_and_draw")
    loop = Loop(fe, engine, Requests(cell.mix, seed,
                                     cell.config["model"]["vocab"]),
                cell.config["model"])
    for _ in range(cell.mix["clients"]):
        loop.send()
    for _ in range(cell.mix["warmup_steps"]):
        loop.turn()
    phases.mark("warmup")
    return loop


def window(loop: Loop, seconds: float) -> tuple[float, float]:
    """Turns until ``seconds`` have passed: ``(start, end)``."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        loop.turn()
    return t0, time.perf_counter()


def drain(loop: Loop, limit_s: float = 60.0) -> None:
    loop.sending = False
    t0 = time.perf_counter()
    while loop.busy() and time.perf_counter() - t0 < limit_s:
        loop.turn()


def served(loop: Loop, t0: float, t1: float) -> dict:
    """The window's requests: rid -> (prompt, served tokens)."""
    return {rid: (loop.prompts[rid], list(loop.fe.jobs[rid].tokens))
            for rid, t in loop.sent.items()
            if t0 <= t < t1 and loop.fe.jobs[rid].status == "done"}


def sample(done: dict, seed: int, want: int) -> list[int]:
    """The request with the most tokens, then others drawn from the seed
    until ``want`` served tokens (none when none finished)."""
    if not done:
        return []
    longest = max(done, key=lambda r: len(done[r][0]) + len(done[r][1]))
    picked, n = [longest], len(done[longest][1])
    rng = np.random.default_rng((seed ^ 0x5EED) % (1 << 63))
    for rid in rng.permutation(sorted(done)):
        if n >= want:
            break
        if rid != longest:
            picked.append(int(rid))
            n += len(done[rid][1])
    return picked


def reference_logits(cell, seed: int, device, seqs, prec: str = "float32"):
    """The reference's logits over each ``(prompt, tokens)``, at the
    positions that predict the tokens: ``[(len(tokens), vocab), ...]``."""
    m = cell.config["model"]
    ref = bench.family_module(cell, "reference")
    p = {n: t.float() for n, t in weights.iter_draw(
        ref.leaf_specs(m), seed, device, weights.DTYPES[m["dtype"]])}
    out = []
    with torch.no_grad(), ref.exact_matmuls():
        for prompt, toks in seqs:
            ids = torch.as_tensor(np.concatenate([prompt, toks[:-1]]),
                                  dtype=torch.long, device=device)[None]
            logits, _ = ref.forward(p, ids, m, prec)
            out.append(logits[0, len(prompt) - 1:])
    return out


def gaps(logits: list, tokens: list):
    """How far each given token's logit lies below the best, in order."""
    if not logits:          # nothing finished: every number reads nan
        return torch.full((1,), float("nan"))
    return torch.cat([
        lg.max(-1).values
        - lg.gather(-1, torch.as_tensor(t, device=lg.device)[:, None])[:, 0]
        for lg, t in zip(logits, tokens)])


def gap_numbers(g) -> dict:
    """The numbers a cell's check may compare: the widest gap
    (``served_gap``), the mean gap, the share of tokens that are not the
    reference's best, and the 99th percentile gap."""
    return {"served_gap": g.max().item(), "mean_gap": g.mean().item(),
            "off_best_share": (g > 0).float().mean().item(),
            "p99_gap": torch.quantile(g.float(), 0.99).item()}


def run(ctx) -> dict:
    cell, device, mix = ctx.cell, ctx.device, ctx.cell.mix
    m = cell.config["model"]
    phases = bench.Phases(ctx.t_start)
    loop = start(cell, ctx.seed, device, phases)
    probe = bench.Probe(device)
    if ctx.trace:
        probe.wrap(loop.engine, "submit", "prefill")
        probe.wrap(loop.engine, "step", "decode")
        probe.timing = True
    bench.sync(device)
    setup_s = time.time() - ctx.t_start

    t0, t1 = window(loop, ctx.seconds)
    phases.mark("window")
    probe.timing = False
    out = {}
    if ctx.trace:
        flash = FlashCost()
        probe.labels = True
        with flash:
            prof = bench.profile(lambda: window(loop, mix["profile_seconds"]),
                                 device)
        out["profile"] = prof
        out["record"] = {
            "kind": "serve", "platform": device.type, "dtype": m["dtype"],
            "window_s": t1 - t0,
            "window_flops": sum(f for t, f in loop.work if t0 < t <= t1),
            "spans": probe.seconds, "calls": probe.calls, "profile": prof,
            "flash_bound_s": flash.bound_s}
    drain(loop)
    phases.mark("profile_and_drain")
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                if device.type == "cuda" else 0)

    in_window = [rid for rid, t in loop.sent.items() if t0 <= t < t1]
    ttft = [loop.times[r][0] - loop.sent[r] for r in in_window
            if loop.times.get(r)]
    itl = [b - a for ts in loop.times.values() for a, b in zip(ts, ts[1:])
           if t0 < b <= t1]
    tokens = sum(1 for ts in loop.times.values() for t in ts if t0 < t <= t1)
    done = served(loop, t0, t1)
    out["attempted"] = len(in_window)
    out["failed"] = len(in_window) - len(done)
    out["end_to_end"] = {
        "serve_tokens_per_s": tokens / (t1 - t0),
        "ttft_p95_ms": 1e3 * bench.quantile(ttft, 0.95),
        "itl_p95_ms": 1e3 * bench.quantile(itl, 0.95),
        "setup_s": setup_s}

    picked = sample(done, ctx.seed, mix["check_tokens"])
    seqs = [done[r] for r in picked]
    del loop, probe, done
    gc.collect()
    bench.sync(device)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    logits = reference_logits(cell, ctx.seed, device, seqs)
    numbers = gap_numbers(gaps(logits, [t for _, t in seqs]))
    phases.mark("reference")
    out["phases"] = phases.seconds
    limits = cell.checks["limits"]
    out["checks"] = {k: {"value": v, "limit": limits[k]}
                     for k, v in numbers.items() if k in limits}
    out["worst"] = {"served_tokens": sum(len(t) for _, t in seqs),
                    "requests_checked": len(seqs),
                    **{k: v for k, v in numbers.items() if k not in limits}}
    return out


class FlashCost:
    """The roofline bound of every flash-attention launch while active
    (the program's attention layers call
    ``models.attention.flash_attention`` once a launch)."""

    def __init__(self):
        self.bound_s = 0.0

    def __enter__(self):
        from repro_torch.models import attention

        self._mod, self._fn = attention, attention.flash_attention

        def counted(q, k, v, *, causal=True):
            B, S, H, dqk = q.shape
            _, T, K, dv = v.shape
            ops, rate, nbytes = flops.flash_cost(
                B, S, T, H, K, dqk, dv, causal, q.element_size(),
                str(q.dtype).split(".")[-1])
            self.bound_s += max(ops / rate, nbytes / flops.HBM_BPS)
            return self._fn(q, k, v, causal=causal)

        attention.flash_attention = counted
        return self

    def __exit__(self, *exc):
        self._mod.flash_attention = self._fn
        return False
