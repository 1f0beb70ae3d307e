"""The differentiable flash route for training attention, on the CPU.

* The plain versions of the training route's kernels
  (``kernels/attention/ref.py``): ``flash_attention_lse_ref`` -- the
  forward and each row's log-sum-exp -- and ``flash_attention_bwd_ref``
  -- the blockwise backward ``csrc/flash_sm90_bwd.cu`` runs (P from the
  log-sum-exp, D = rowsum(dO o), dS = P (dP - D), dK / dV summed over a
  kv head's query heads) -- held to autograd through
  ``flash_attention_ref`` and through ``models.attention._attend``, in
  float32 (1e-5 of the largest gradient) and in bfloat16 (against the
  float64 gradients: 2e-2 of the largest, P and dS rounded to bfloat16
  as the products' operands), at G 1, 6 and 8, lengths off every tile,
  key blocks of 64 and 32.
* The operator ``repro_torch::flash_attention_train`` (``torch.library``
  ``opcheck`` on its CPU implementation), its gradients, and the model
  under the ``dots`` policy with the route forced onto it: the same loss
  and gradients as the plain route, the operator recomputed, not saved.
* The route (``flash.train_kernel_for``): which shapes, dtypes, strides,
  windows and devices go to the kernels and which to ``_attend``; the
  counters (plain calls off the CPU only) and the ``attention.core``
  span ``gqa`` records.
* ``chip_smoke.py``'s training phases: the layers it predicts on the
  route are those the model sends there, and the launches it requires.
The kernels run only on the card (``tests/test_torch_cuda_flash_train.py``).
"""

import dataclasses
import math

import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import LAUNCH_COUNTERS, _build
from repro_torch.kernels.attention import flash as fl
from repro_torch.kernels.attention import ops as fops
from repro_torch.kernels.attention.ref import (flash_attention_bwd_ref,
                                               flash_attention_lse_ref,
                                               flash_attention_ref)
from repro_torch.models import attention as tattn
from repro_torch.models import model as tmodel
from repro_torch.runtime import spans

BF16 = torch.bfloat16
F32 = torch.float32


def _inputs(B, S, H, K, dh, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    ts = [torch.randn(B, S, n, dh, generator=gen, dtype=torch.float64)
          for n in (H, K, K, H)]
    return [t.to(dtype) for t in ts]


def _truth(q, k, v, dout):
    """The float64 output and gradients of ``q, k, v`` as given."""
    q, k, v = [t.detach().double().requires_grad_() for t in (q, k, v)]
    out = flash_attention_ref(q, k, v)
    return (out, *torch.autograd.grad(out, (q, k, v), dout.double()))


def _rel(got, want):
    return ((got.double() - want.double()).abs().max()
            / want.double().abs().max()).item()


SHAPES = [(2, 37, 6, 1, 16),        # G 6 over one kv head, S off the tile
          (1, 130, 8, 1, 32),       # G 8 (MQA), two tiles and a part
          (2, 67, 4, 4, 8),         # G 1
          (1, 64, 12, 2, 16)]       # qwen2's grouping, one whole tile


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("B,S,H,K,dh", SHAPES)
def test_lse_ref_is_the_forward_and_its_log_sum_exp(dtype, B, S, H, K, dh):
    q, k, v, _ = _inputs(B, S, H, K, dh, dtype, S + H)
    out, lse = flash_attention_lse_ref(q, k, v)
    assert lse.shape == (B, H, S) and lse.dtype == F32
    want = flash_attention_ref(q, k, v)
    tol = 1e-6 if dtype == F32 else 1e-2
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)
    G = H // K
    qg = q.double().reshape(B, S, K, G, dh)
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.double()) / math.sqrt(dh)
    s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(), -math.inf)
    torch.testing.assert_close(lse.double(),
                               torch.logsumexp(s, -1).reshape(B, H, S),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("block", [64, 32])
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("B,S,H,K,dh", SHAPES)
def test_blockwise_backward_matches_autograd(block, dtype, B, S, H, K, dh):
    """float32: within 1e-5 of the largest float64 gradient; bfloat16:
    within 2e-2 (P and dS rounded to bfloat16 before the products, the
    output and the gradients rounded once)."""
    q, k, v, dout = _inputs(B, S, H, K, dh, dtype, 3 * S + K)
    out, lse = flash_attention_lse_ref(q, k, v)
    got = flash_attention_bwd_ref(q, k, v, out, lse, dout, block=block)
    _, *want = _truth(q, k, v, dout)
    tol = 1e-5 if dtype == F32 else 2e-2
    for g, w, t in zip(got, want, (q, k, v)):
        assert g.dtype == t.dtype and g.shape == t.shape
        assert _rel(g, w) <= tol


@pytest.mark.parametrize("G", [1, 6, 8])
def test_blockwise_backward_matches_autograd_through_attend(G):
    """The plain route ``Model.loss`` takes on the CPU, in float32."""
    B, S, K, dh = 2, 45, 2, 16
    q, k, v, dout = _inputs(B, S, G * K, K, dh, F32, G)
    out, lse = flash_attention_lse_ref(q, k, v)
    got = flash_attention_bwd_ref(q, k, v, out, lse, dout)
    qq, kk, vv = [t.clone().requires_grad_() for t in (q, k, v)]
    pos = torch.arange(S).expand(B, S)
    o = tattn._attend(qq.reshape(B, S, K, G, dh), kk, vv, pos, pos)
    want = torch.autograd.grad(o, (qq, kk, vv),
                               dout.reshape(B, S, K, G, dh))
    torch.testing.assert_close(out, o.reshape(B, S, G * K, dh), rtol=1e-5,
                               atol=1e-5)
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-5


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_operator_differentiates_as_the_plain_version(dtype):
    B, S, H, K, dh = 2, 70, 6, 2, 16
    q, k, v, dout = _inputs(B, S, H, K, dh, dtype, 5)
    qq, kk, vv = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fops.flash_attention_train(qq, kk, vv)
    got = torch.autograd.grad(out, (qq, kk, vv), dout)
    want_out, *want = _truth(q, k, v, dout)
    tol = 1e-5 if dtype == F32 else 2e-2
    assert _rel(out, want_out) <= (1e-6 if dtype == F32 else 1e-2)
    for g, w in zip(got, want):
        assert _rel(g, w) <= tol


@pytest.mark.parametrize("op", ["forward", "backward"])
def test_opcheck_on_the_cpu_implementation(op):
    q, k, v, dout = _inputs(1, 20, 4, 2, 8, F32, 11)
    if op == "forward":
        args = tuple(t.requires_grad_() for t in (q, k, v))
        torch.library.opcheck(fops._train_fwd, args)
    else:
        out, lse = flash_attention_lse_ref(q, k, v)
        torch.library.opcheck(fops._train_bwd, (q, k, v, out, lse, dout))


# --------------------------------------------------------------------------
# the route
# --------------------------------------------------------------------------

def _qkv(B=2, S=40, H=6, K=2, dh=128, dtype=BF16, device="cpu"):
    return (torch.zeros(B, S, H, dh, dtype=dtype, device=device),
            torch.zeros(B, S, K, dh, dtype=dtype, device=device),
            torch.zeros(B, S, K, dh, dtype=dtype, device=device))


def _fused(B, S, H, K, dh, width, offset=0):
    qkv = torch.zeros(B, S, width, dtype=BF16)[..., offset:]
    q = qkv[..., :H * dh].view(B, S, H, dh)
    k = qkv[..., H * dh:(H + K) * dh].view(B, S, K, dh)
    v = qkv[..., (H + K) * dh:(H + 2 * K) * dh].view(B, S, K, dh)
    return q, k, v


@pytest.mark.parametrize("dh", fl.BWD_HEAD_DIMS)
@pytest.mark.parametrize("B,S,H,K", [(4, 2048, 12, 2), (8, 512, 48, 8),
                                     (1, 1, 32, 4), (2, 65, 8, 8),
                                     (1, 1000, 10, 1)])
def test_the_kernels_take_bf16_gqa_at_their_head_dims(dh, B, S, H, K):
    q, k, v = _qkv(B, S, H, K, dh)
    assert fl.sm90_train_takes(q, k, v)
    assert fl.sm90_train_takes(q, k, v, window=S)    # no key masked
    # the same shapes off the card stay on the plain route
    assert fl.train_kernel_for(q, k, v) == "plain"


def _strided_head_dim():
    q, k, v = _qkv()
    return q.transpose(-1, -2).contiguous().transpose(-1, -2), k, v


@pytest.mark.parametrize("make", [
    lambda: _qkv(dtype=F32),                       # float32: no TF32 here
    lambda: _qkv(dtype=torch.float16),
    lambda: _qkv(dh=256),                          # recurrentgemma's
    lambda: _qkv(dh=32),                           # the reduced configs'
    lambda: _qkv(dh=80),
    lambda: (*_qkv()[:2], torch.zeros(2, 40, 2, 64, dtype=BF16)),  # dv 64
    lambda: (_qkv(H=5)[0], *_qkv()[1:]),           # H % K
    lambda: (_qkv(S=40)[0], *_qkv(S=48)[1:]),      # keys of another length
    _strided_head_dim,
    lambda: (_qkv(K=1)[0], *(t.expand(2, 40, 2, 128)
                             for t in _qkv(K=1)[1:])),   # an expanded kv head
    lambda: _fused(1, 40, 1, 1, 128, 3 * 128 + 2),       # strides off grid
    lambda: _fused(1, 40, 1, 1, 128, 3 * 128 + 8, offset=4),  # pointers
], ids=["float32", "float16", "dh256", "dh32", "dh80", "dv-differs",
        "heads-off-groups", "cross-length", "head-dim-strided",
        "zero-stride", "stride-off-grid", "pointer-off-grid"])
def test_what_the_kernels_do_not_take_goes_to_attend(make):
    assert not fl.sm90_train_takes(*make())


def test_a_window_that_masks_a_key_goes_to_attend():
    q, k, v = _qkv(S=40)
    assert fl.sm90_train_takes(q, k, v, window=40)
    assert not fl.sm90_train_takes(q, k, v, window=39)


def test_fused_projection_views_on_the_grid_take_the_kernels():
    q, k, v = _fused(2, 77, 4, 2, 64, 8 * 64 + 8, offset=8)
    assert not q.is_contiguous() and fl.sm90_train_takes(q, k, v)


def test_other_devices_stay_on_the_plain_route():
    for device in ("cpu", "meta"):
        assert fl.train_kernel_for(*_qkv(device=device)) == "plain"


def test_the_kernels_refuse_what_the_route_refuses():
    with pytest.raises(ValueError, match="CUDA"):
        fl.flash_attention_lse_cuda(*_qkv())
    with pytest.raises(ValueError, match="CUDA"):
        fl.flash_attention_bwd_cuda(*_qkv(), *_qkv()[:1],
                                    torch.zeros(2, 6, 40), _qkv()[0])


def test_build_and_counters_name_the_training_kernels():
    src = _build.SOURCES["flash_sm90_bwd"]
    assert src.name == "flash_sm90_bwd.cu" and src.exists()
    text = src.read_text()
    for name in ("flash_attention_bwd_dkdv_sm90", "flash_attention_bwd_dq_sm90",
                 "flash_attention_bwd_dsum_sm90", "wgmma.mma_async",
                 "cp.async.bulk.tensor", "mbarrier.try_wait"):
        assert name in text
    # the backward's dims are the ones the route admits
    for dh in fl.BWD_HEAD_DIMS:
        assert f"if (dh == {dh})" in text
    fwd = _build.SOURCES["flash_sm90"].read_text()
    assert "flash_attention_sm90_fwd_lse" in fwd
    for dh in fl.BWD_HEAD_DIMS:
        assert f"return run_lse<{dh}>" in fwd
    assert LAUNCH_COUNTERS["flash_attention_sm90_lse"] \
        is fl.launch_flash_sm90_lse
    assert LAUNCH_COUNTERS["flash_attention_sm90_bwd"] \
        is fl.launch_flash_sm90_bwd


# --------------------------------------------------------------------------
# gqa and the model
# --------------------------------------------------------------------------

def _gqa_params(d, H, K, dh, dtype, seed=3):
    gen = torch.Generator().manual_seed(seed)
    p = {n: torch.randn(d, w, generator=gen).to(dtype) / math.sqrt(d)
         for n, w in (("wq", H * dh), ("wk", K * dh), ("wv", K * dh))}
    p["wo"] = torch.randn(H * dh, d, generator=gen).to(dtype) / math.sqrt(d)
    return p


@pytest.mark.parametrize("route", ["sm90", "plain"])
def test_gqa_attends_by_the_route_and_counts_it(route, monkeypatch):
    H, K, dh, d, S = 4, 2, 16, 32, 9
    params = _gqa_params(d, H, K, dh, F32)
    x = torch.randn(2, S, d, generator=torch.Generator().manual_seed(4))
    seen = []
    monkeypatch.setattr(tattn, "train_kernel_for",
                        lambda q, k, v, window=0: seen.append(window)
                        or route)
    calls = {"op": 0, "attend": 0}
    real_op, real_attend = tattn.flash_attention_train, tattn._attend

    def op(*a):
        calls["op"] += 1
        return real_op(*a)

    def attend(*a, **kw):
        calls["attend"] += 1
        return real_attend(*a, **kw)

    monkeypatch.setattr(tattn, "flash_attention_train", op)
    monkeypatch.setattr(tattn, "_attend", attend)
    with spans.recording() as rec:
        out, _ = tattn.gqa(params, x, torch.arange(S).expand(2, S), H=H,
                           K=K, dh=dh, differentiable=True)
    want = {"op": 1, "attend": 0} if route == "sm90" else \
        {"op": 0, "attend": 1}
    assert calls == want and seen == [0]
    # the CPU's plain calls are not counted: it has no kernels
    assert rec.counters == ({"attention.kernel_calls": 1}
                            if route == "sm90" else {})
    assert [s.name for s in rec.spans] == ["attention.core"]
    # both routes compute the same function
    monkeypatch.setattr(tattn, "train_kernel_for",
                        lambda q, k, v, window=0: "plain")
    ref, _ = tattn.gqa(params, x, torch.arange(S).expand(2, S), H=H, K=K,
                       dh=dh, differentiable=True)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kernel,device,want", [
    (True, "cpu", {"attention.kernel_calls": 1}),
    (False, "cpu", {}),
    (True, "meta", {"attention.kernel_calls": 1}),
    (False, "meta", {"attention.plain_calls": 1})])
def test_plain_calls_count_off_the_cpu_only(kernel, device, want):
    with spans.recording() as rec:
        tattn._count(kernel, torch.empty(1, device=device))
    assert rec.counters == want


def test_forward_only_and_windowed_passes_keep_their_routes(monkeypatch):
    """Without ``differentiable`` the forward-only kernel wrapper (the
    plain version here), a prompt longer than its window ``_attend``;
    neither asks the training route nor counts."""
    H, K, dh, d, S = 4, 2, 16, 32, 9
    params = _gqa_params(d, H, K, dh, F32)
    x = torch.randn(1, S, d, generator=torch.Generator().manual_seed(5))
    asked = []
    monkeypatch.setattr(tattn, "train_kernel_for",
                        lambda q, k, v, window=0: asked.append(window)
                        or "sm90")
    pos = torch.arange(S)[None]
    with spans.recording() as rec:
        tattn.gqa(params, x, pos, H=H, K=K, dh=dh)
        tattn.gqa(params, x, pos, H=H, K=K, dh=dh, window=4)
    assert asked == [] and rec.counters == {}
    with spans.recording() as rec:
        tattn.gqa(params, x, pos, H=H, K=K, dh=dh, window=4,
                  differentiable=True)
    assert asked == [4]             # the route decides (the stub says yes)
    assert rec.counters == {"attention.kernel_calls": 1}


def _dots_model():
    cfg = dataclasses.replace(configs.reduced("qwen2-1.5b"), remat="dots",
                              dtype=F32)
    model = tmodel.build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    tok = torch.randint(0, cfg.vocab, (2, 17),
                        generator=torch.Generator().manual_seed(1))
    return model, params, {"tokens": tok[:, :-1], "labels": tok[:, 1:]}


def _loss_and_grads(model, params, batch):
    leaves = [p.requires_grad_() for p in
              torch.utils._pytree.tree_leaves(params)
              if p.is_floating_point()]
    loss = model.loss(params, batch)
    return loss, torch.autograd.grad(loss, leaves)


def test_dots_model_through_the_operator_matches_the_plain_route(
        monkeypatch):
    """qwen2-smoke under ``dots`` with the route forced onto the operator
    (its CPU implementation): the plain route's loss and gradients
    within 1e-5; the policy recomputes the operator (it is not
    ``aten.mm``): two calls a layer, the forward's and the backward's
    recomputation, and the policy never saves it."""
    model, params, batch = _dots_model()
    loss0, g0 = _loss_and_grads(model, params, batch)
    monkeypatch.setattr(tattn, "train_kernel_for",
                        lambda q, k, v, window=0: "sm90")
    calls, decisions = [], []
    real, dots = fops._train_fwd._opoverload, tmodel.dots_policy

    def policy(ctx, op, *args, **kwargs):
        decision = dots(ctx, op, *args, **kwargs)
        if op is real:
            decisions.append(decision)
        return decision

    monkeypatch.setattr(tmodel, "dots_policy", policy)
    real_train = tattn.flash_attention_train
    monkeypatch.setattr(tattn, "flash_attention_train",
                        lambda *a: calls.append(1) or real_train(*a))
    loss1, g1 = _loss_and_grads(model, params, batch)
    layers = model.cfg.n_layers
    assert len(calls) == 2 * layers and len(decisions) >= layers
    assert all(d == torch.utils.checkpoint.CheckpointPolicy.PREFER_RECOMPUTE
               for d in decisions)
    torch.testing.assert_close(loss1, loss0, rtol=1e-6, atol=1e-6)
    for a, b in zip(g1, g0):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch,seq,dtype", [
    ("qwen2-1.5b", 16, BF16), ("qwen2-1.5b", 16, F32),
    ("tinyllama-1.1b", 16, BF16), ("dbrx-132b", 16, BF16),
    ("recurrentgemma-2b", 16, BF16),      # S <= window: the local layer
    ("recurrentgemma-2b", 24, BF16),      # S > window: _attend
    ("xlstm-350m", 16, BF16), ("deepseek-v2-236b", 16, BF16)])
def test_chip_smokes_route_prediction_is_the_models(arch, seq, dtype,
                                                    monkeypatch):
    """``chip_smoke.train_route_layers`` -- the launches the card's
    training phases require -- counts the layers whose pass the model
    sends to the kernels: ``sm90_train_takes`` on the inputs ``gqa``
    builds (the device left aside), at dh 64."""
    import chip_smoke

    cfg = dataclasses.replace(configs.reduced(arch), d_head=64, dtype=dtype,
                              remat="none")
    assert cfg.window in (0, 16)
    model = tmodel.build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    tok = torch.randint(0, cfg.vocab, (1, seq + 1),
                        generator=torch.Generator().manual_seed(2))
    routes = []

    def route(q, k, v, window=0):
        routes.append("sm90" if fl.sm90_train_takes(q, k, v, window=window)
                      else "plain")
        return routes[-1]

    monkeypatch.setattr(tattn, "train_kernel_for", route)
    model.loss(params, {"tokens": tok[:, :-1], "labels": tok[:, 1:]})
    assert routes.count("sm90") == chip_smoke.train_route_layers(
        torch, cfg, seq)


@pytest.mark.parametrize("remat,fwd", [("none", 2 * 28), ("dots", 4 * 28)])
def test_chip_smoke_requires_the_launches_the_route_predicts(remat, fwd):
    """``chip_smoke.check_train_route``: ``passes`` passes of qwen2-1.5b
    at full depth launch the forward once a layer (twice where the
    policy recomputes it) and the backward once a layer; any other
    count raises."""
    import chip_smoke

    cfg = dataclasses.replace(configs.full("qwen2-1.5b"), remat=remat)
    counts = {"flash_attention_sm90_lse": fwd,
              "flash_attention_sm90_bwd": 2 * 28}
    assert chip_smoke.check_train_route(torch, cfg, 512, 2, counts, "t") == 28
    for name in counts:
        with pytest.raises(AssertionError, match="training flash launches"):
            chip_smoke.check_train_route(torch, cfg, 512, 2,
                                         dict(counts, **{name: 0}), "t")
