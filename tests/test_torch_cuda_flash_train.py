"""The training route's kernels on a CUDA card (skipped without one): the
Hopper forward with the log-sum-exp (``flash_attention_sm90_fwd_lse``)
and the Hopper backward (``csrc/flash_sm90_bwd.cu``).  Run on a machine
with an H100 and nvcc:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_flash_train.py

Tolerances, each over the largest magnitude of what it compares:
* against float32 autograd through ``flash_attention_ref`` on the same
  bfloat16 inputs, output and gradients 1e-2: the kernels round P (and
  dS) to bfloat16 as the products' operands and every output to
  bfloat16 once (2^-8 = 3.9e-3 relative a value), the reference rounds
  nothing but its probabilities; log-sum-exp 1e-4 absolute (float32
  both, other summation orders);
* against the blockwise plain version (``flash_attention_bwd_ref``) on
  the same inputs, 1e-2: the same roundings, taken at other places of
  the tensor cores' float32 sums (no atomics: every gradient is summed
  in one order, so the kernel is bitwise the same run to run);
* the serving forward bitwise: the flag leaves its instantiations as
  they were, so the log-sum-exp route's output is the serving kernel's.
"""

import dataclasses

import pytest
import torch

from repro_torch.kernels import launch_counts, reset_launch_counts

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the card with -m cuda")
    return torch.device("cuda")


def _inputs(B, S, H, K, dh, seed, device):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(B, S, n, dh, generator=gen).to(device, torch.bfloat16)
            for n in (H, K, K, H)]


def _rel(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


SHAPES = [(4, 2048, 12, 2, 128),     # qwen2-1.5b's training shape
          (8, 512, 48, 8, 128),      # dbrx-132b's
          (2, 1000, 8, 2, 64),       # dh 64, S off the tile
          (1, 200, 6, 1, 128),       # MQA, a partial last tile
          (2, 65, 4, 4, 64)]         # G 1, one row past a tile


@pytest.mark.parametrize("B,S,H,K,dh", SHAPES)
def test_kernels_match_float32_autograd(cuda, B, S, H, K, dh):
    from repro_torch.kernels.attention import flash as fl
    from repro_torch.kernels.attention import ref

    q, k, v, dout = _inputs(B, S, H, K, dh, S + H, cuda)
    assert fl.train_kernel_for(q, k, v) == "sm90"
    out, lse = fl.flash_attention_lse_cuda(q, k, v)
    dq, dk, dv = fl.flash_attention_bwd_cuda(q, k, v, out, lse, dout)
    qf, kf, vf = [t.float().requires_grad_() for t in (q, k, v)]
    want = ref.flash_attention_ref(qf, kf, vf)
    grads = torch.autograd.grad(want, (qf, kf, vf), dout.float())
    with torch.no_grad():
        _, lse_want = ref.flash_attention_lse_ref(qf, kf, vf)
    assert _rel(out, want) <= 1e-2
    assert (lse - lse_want).abs().max().item() <= 1e-4
    for got, g, t in zip((dq, dk, dv), grads, (q, k, v)):
        assert got.shape == t.shape and got.dtype == torch.bfloat16
        assert torch.isfinite(got).all()
        assert _rel(got, g) <= 1e-2


@pytest.mark.parametrize("B,S,H,K,dh", SHAPES[2:])
def test_backward_matches_the_blockwise_plain_version(cuda, B, S, H, K, dh):
    from repro_torch.kernels.attention import flash as fl
    from repro_torch.kernels.attention import ref

    q, k, v, dout = _inputs(B, S, H, K, dh, 2 * S, cuda)
    out, lse = fl.flash_attention_lse_cuda(q, k, v)
    got = fl.flash_attention_bwd_cuda(q, k, v, out, lse, dout)
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout)
    again = fl.flash_attention_bwd_cuda(q, k, v, out, lse, dout)
    for g, w, a in zip(got, want, again):
        assert _rel(g, w) <= 1e-2
        assert torch.equal(g, a)             # no atomics: the same bits


@pytest.mark.parametrize("B,S,H,K,dh", [(4, 2048, 12, 2, 128),
                                        (1, 1024, 32, 4, 64),
                                        (2, 77, 8, 8, 128)])
def test_serving_forward_is_the_log_sum_exp_routes_output(cuda, B, S, H, K,
                                                          dh):
    from repro_torch.kernels.attention import flash as fl

    q, k, v, _ = _inputs(B, S, H, K, dh, 9, cuda)
    out, _ = fl.flash_attention_lse_cuda(q, k, v)
    assert torch.equal(fl.flash_attention_cuda(q, k, v), out)


def test_operator_counts_its_launches_and_refuses(cuda):
    from repro_torch.kernels.attention import flash as fl
    from repro_torch.kernels.attention import ops

    q, k, v, dout = _inputs(2, 130, 6, 2, 128, 3, cuda)
    q, k, v = [t.requires_grad_() for t in (q, k, v)]
    reset_launch_counts()
    out = ops.flash_attention_train(q, k, v)
    torch.autograd.grad(out, (q, k, v), dout)
    counts = launch_counts()
    assert counts["flash_attention_sm90_lse"] == 1
    assert counts["flash_attention_sm90_bwd"] == 1
    assert counts["flash_attention_sm90"] == counts["flash_attention"] == 0
    for bad in (_inputs(1, 64, 2, 1, 256, 1, cuda),            # dh 256
                [t.float() for t in _inputs(1, 64, 2, 1, 64, 1, cuda)]):
        with pytest.raises(ValueError, match="train_kernel_for"):
            fl.flash_attention_lse_cuda(*bad[:3])


def _model(cuda, remat):
    from repro_torch import configs
    from repro_torch.models import model as tmodel

    cfg = configs.reduced("qwen2-1.5b")
    cfg = dataclasses.replace(cfg, remat=remat, dtype=torch.bfloat16,
                              d_model=64 * cfg.n_heads)       # dh 64
    model = tmodel.build_model(cfg, device=cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    tok = torch.randint(0, cfg.vocab, (4, 129),
                        generator=torch.Generator().manual_seed(1)).to(cuda)
    return model, params, {"tokens": tok[:, :-1], "labels": tok[:, 1:]}


@pytest.mark.parametrize("remat", ["none", "dots"])
def test_model_loss_on_the_card_takes_the_kernels(cuda, remat, monkeypatch):
    """A bf16 qwen2-smoke at dh 64: ``Model.loss`` attends through the
    operator (one forward launch a layer, one more a layer recomputed
    under dots, one backward a layer; counted as kernel calls, and as
    plain calls with the route forced off it), and its loss and gradients are as
    close to the float32 model's (the plain route, TF32 off) as the bf16
    plain route's are: within 1.5 times its distance and 1e-3 of the
    largest (the kernels keep the scores float32 where the plain route
    rounds them to bfloat16)."""
    from repro_torch.models import attention as tattn
    from repro_torch.models import model as tmodel
    from repro_torch.runtime import spans
    from repro_torch.tree import tree_leaves, tree_map

    model, params, batch = _model(cuda, remat)
    assert model.cfg.dh == 64
    params32 = tree_map(lambda t: t.float() if t.is_floating_point() else t,
                        params)

    def loss_and_grads(m, p):
        leaves = [x.requires_grad_() for x in tree_leaves(p)
                  if x.is_floating_point()]
        loss = m.loss(p, batch)
        return loss.item(), torch.autograd.grad(loss, leaves)

    reset_launch_counts()
    with spans.recording() as rec:
        loss, grads = loss_and_grads(model, params)
    layers = model.cfg.n_layers
    # outside a trainer no model.backward span holds the recomputation,
    # so the counters see it as the launches do
    calls = layers * (2 if remat == "dots" else 1)
    assert rec.counters == {"attention.kernel_calls": calls}
    counts = launch_counts()
    assert counts["flash_attention_sm90_lse"] == calls
    assert counts["flash_attention_sm90_bwd"] == layers
    f32 = tmodel.build_model(dataclasses.replace(model.cfg,
                                                 dtype=torch.float32),
                             device=cuda)
    loss32, grads32 = loss_and_grads(f32, params32)
    monkeypatch.setattr(tattn, "train_kernel_for",
                        lambda q, k, v, window=0: "plain")
    with spans.recording() as rec:
        loss0, grads0 = loss_and_grads(model, params)
    assert rec.counters == {"attention.plain_calls": calls}
    assert launch_counts()["flash_attention_sm90_bwd"] == layers
    assert abs(loss - loss32) <= 1.5 * abs(loss0 - loss32) + 1e-3
    for g, g0, g32 in zip(grads, grads0, grads32):
        assert _rel(g, g32) <= 1.5 * _rel(g0, g32) + 1e-3
