"""Which flash-attention kernel takes which input, decided on the CPU.

``kernels.attention.flash.flash_kernel_for`` is a pure function of
dtype, shapes, strides and pointer alignment: the Hopper kernel
(``csrc/flash_sm90.cu``, TMA + ``wgmma``) takes bfloat16 q, k, v on
TMA's 16-byte grid at (q·k, v) head dims (64, 64), (128, 128), MLA's
(192, 128) and (256, 256), and the simple kernel (``csrc/flash.cu``)
everything else the wrapper accepts.  Both kernels
run only on the card (``tests/test_torch_cuda.py``); here the choice,
the build registry and the counters are checked without one.
"""

import pytest
import torch

from repro_torch.kernels import LAUNCH_COUNTERS, _build
from repro_torch.kernels import attention as fa
from repro_torch.kernels.attention import flash as fl
from repro_torch.models import attention as tattn

BF16 = torch.bfloat16


def _qkv(B=1, S=40, H=4, K=2, dh=64, dtype=BF16):
    return (torch.zeros(B, S, H, dh, dtype=dtype),
            torch.zeros(B, S, K, dh, dtype=dtype),
            torch.zeros(B, S, K, dh, dtype=dtype))


def _fused(B, S, H, K, dh, width, offset=0, dtype=BF16):
    """q, k, v as views of one fused projection of ``width`` columns,
    starting ``offset`` elements in (no copy)."""
    qkv = torch.zeros(B, S, width, dtype=dtype)[..., offset:]
    q = qkv[..., :H * dh].view(B, S, H, dh)
    k = qkv[..., H * dh:(H + K) * dh].view(B, S, K, dh)
    v = qkv[..., (H + K) * dh:(H + 2 * K) * dh].view(B, S, K, dh)
    return q, k, v


@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("H,K", [(8, 8), (8, 2), (8, 1), (32, 4), (12, 2)])
@pytest.mark.parametrize("B,S", [(1, 1), (2, 65), (1, 1024)])
def test_hopper_kernel_takes_bf16_at_head_dims_64_and_128(dh, H, K, B, S):
    assert fl.flash_kernel_for(*_qkv(B, S, H, K, dh)) == "sm90"


def _head_dim_not_contiguous():
    q, k, v = _qkv()
    return q.transpose(-1, -2).contiguous().transpose(-1, -2), k, v


def _mixed_dtypes():
    q, k, v = _qkv()
    return q.float(), k, v


def _shared_kv_heads():
    q, k, v = _qkv(K=1)
    return q, k.expand(1, 40, 2, 64), v.expand(1, 40, 2, 64)


@pytest.mark.parametrize("make", [
    lambda: _qkv(dtype=torch.float32),          # float32: the simple kernel
    lambda: _qkv(dh=128, dtype=torch.float32),
    lambda: _qkv(dh=16), lambda: _qkv(dh=32), lambda: _qkv(dh=48),
    lambda: _qkv(dh=100), lambda: _qkv(dh=96),
    _mixed_dtypes,
    _head_dim_not_contiguous,                   # stride(-1) != 1
    _shared_kv_heads,                           # a zero stride
    # a row of 3*64 + 4 columns: 392-byte strides, off the 16-byte grid
    lambda: _fused(1, 40, 1, 1, 64, 3 * 64 + 4),
    # strides on the grid, pointers 8 bytes off it
    lambda: _fused(1, 40, 1, 1, 64, 3 * 64 + 8, offset=4),
], ids=["float32", "float32-dh128", "dh16", "dh32", "dh48", "dh100", "dh96",
        "mixed-dtypes", "head-dim-strided", "zero-stride",
        "stride-off-grid", "pointer-off-grid"])
def test_other_inputs_go_to_the_simple_kernel(make):
    assert fl.flash_kernel_for(*make()) == "simple"


def test_hopper_kernel_takes_fused_projection_views():
    """Views of one fused qkv projection load by TMA without a copy when
    their strides and pointers sit on the 16-byte grid."""
    q, k, v = _fused(2, 77, 4, 2, 64, 8 * 64 + 8, offset=8)
    assert not q.is_contiguous()
    assert fl.flash_kernel_for(q, k, v) == "sm90"


def test_prompt_pass_of_a_bf16_gqa_layer_takes_the_hopper_kernel(
        monkeypatch):
    """The q, k, v that the model's prompt pass hands the flash route
    (projections, rope, reshape) at dh 64 in bfloat16 are inputs the
    Hopper kernel takes."""
    H, K, dh, d, S = 4, 2, 64, 256, 9
    gen = torch.Generator().manual_seed(3)
    params = {name: torch.randn(d, n, generator=gen).to(BF16)
              for name, n in (("wq", H * dh), ("wk", K * dh),
                              ("wv", K * dh))}
    params["wo"] = torch.randn(H * dh, d, generator=gen).to(BF16)
    x = torch.randn(1, S, d, generator=gen).to(BF16)
    seen = []

    def spy(q, k, v):
        seen.append(fl.flash_kernel_for(q, k, v))
        return fa.flash_attention_ref(q, k, v)

    monkeypatch.setattr(tattn, "flash_attention", spy)
    tattn.gqa(params, x, torch.arange(S)[None], H=H, K=K, dh=dh)
    assert seen == ["sm90"]


def test_wrapper_refuses_cpu_tensors_whatever_the_kernel():
    """A tensor off the card never reaches either kernel: the wrapper
    refuses it before choosing, a forced kernel included."""
    for kernel in (None, "sm90", "simple"):
        with pytest.raises(ValueError, match="CUDA"):
            fa.flash_attention_cuda(*_qkv(), kernel=kernel)


def test_build_registers_the_hopper_source_for_sm90a():
    src = _build.SOURCES["flash_sm90"]
    assert src.name == "flash_sm90.cu" and src.exists()
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    text = src.read_text()
    # chip_smoke.py and the profiler match kernels on this substring
    assert "flash_attention_kernel_sm90" in text
    for ptx in ("cp.async.bulk.tensor", "mbarrier.try_wait",
                "wgmma.mma_async"):
        assert ptx in text
    assert _build.library_path("flash_sm90").name.startswith("libflash_sm90")


def test_counters_name_both_flash_kernels():
    assert LAUNCH_COUNTERS["flash_attention"] is fl.flash_attention_cuda
    assert LAUNCH_COUNTERS["flash_attention_sm90"] is fl.launch_flash_sm90
    assert LAUNCH_COUNTERS["flash_attention_noncausal"] \
        is fl.noncausal_launches


@pytest.mark.parametrize("T", [1, 1000, 1600])
def test_route_does_not_depend_on_causality_or_key_length(T):
    """Cross-attention's q (B, S, H, dh) over k / v (B, T, K, dh) at
    another length goes where the same dtype, head dim and grid send a
    prompt over itself."""
    q = torch.zeros(1, 7, 8, 128, dtype=BF16)
    kv = torch.zeros(1, T, 2, 128, dtype=BF16)
    assert fl.flash_kernel_for(q, kv, kv) == "sm90"
    assert fl.flash_kernel_for(q.float(), kv.float(), kv.float()) == "simple"


def test_cross_attention_prompt_pass_takes_the_hopper_kernel(monkeypatch):
    """The q, k, v that a bf16 cross layer's prompt pass hands the flash
    route (projections, q / k norms, reshape) at dh 64 are inputs the
    Hopper kernel takes, with ``causal=False``."""
    H, K, dh, d, S, N = 4, 2, 64, 256, 9, 20
    gen = torch.Generator().manual_seed(5)
    params = tattn.init_cross(gen, d, H, K, dh)
    params = {k: v.to(BF16) if k.startswith("w") else v
              for k, v in params.items()}
    x = torch.randn(1, S, d, generator=gen).to(BF16)
    feats = torch.randn(1, N, d, generator=gen)
    seen = []

    def spy(q, k, v, causal=True):
        seen.append((fl.flash_kernel_for(q, k, v), tuple(k.shape), causal))
        return fa.flash_attention_ref(q, k, v, causal=causal)

    monkeypatch.setattr(tattn, "flash_attention", spy)
    tattn.cross_attention(params, x, feats, H=H, K=K, dh=dh)
    assert seen == [("sm90", (1, N, K, dh), False)]


# -- MLA's q·k 192 / v 128 and head dim 256 ----------------------------------

def _pair(B=1, S=40, T=None, H=4, K=2, dqk=192, dv=128, dtype=BF16):
    T = S if T is None else T
    return (torch.zeros(B, S, H, dqk, dtype=dtype),
            torch.zeros(B, T, K, dqk, dtype=dtype),
            torch.zeros(B, T, K, dv, dtype=dtype))


@pytest.mark.parametrize("dqk,dv", [(192, 128), (256, 256)])
@pytest.mark.parametrize("H,K", [(128, 128), (8, 2), (10, 1)])
@pytest.mark.parametrize("B,S", [(1, 1), (2, 65), (1, 1024)])
def test_hopper_kernel_takes_bf16_mla_and_dh_256(dqk, dv, H, K, B, S):
    assert fl.flash_kernel_for(*_pair(B, S, H=H, K=K, dqk=dqk, dv=dv)) \
        == "sm90"


@pytest.mark.parametrize("dqk,dv", [(192, 128), (256, 256)])
@pytest.mark.parametrize("T", [1, 129, 1000])
def test_route_at_mla_and_dh_256_does_not_depend_on_key_length(dqk, dv, T):
    """Without causality (T != S) the new pairs go where a prompt over
    itself goes: bfloat16 to the Hopper kernel, float32 to the simple
    one."""
    assert fl.flash_kernel_for(*_pair(1, 7, T, dqk=dqk, dv=dv)) == "sm90"
    assert fl.flash_kernel_for(*_pair(1, 7, T, dqk=dqk, dv=dv,
                                      dtype=torch.float32)) == "simple"


def _pair_expanded(dqk, dv):
    q, k, v = _pair(K=1, dqk=dqk, dv=dv)
    return q, k.expand(1, 40, 4, dqk), v.expand(1, 40, 4, dv)


def _pair_off_grid(dqk, dv):
    """q a view 8 bytes into a wider row: its pointer off the grid."""
    q, k, v = _pair(dqk=dqk, dv=dv)
    return torch.zeros(1, 40, 4, dqk + 8, dtype=BF16)[..., 4:4 + dqk], k, v


def _pair_head_dim_strided(dqk, dv):
    q, k, v = _pair(dqk=dqk, dv=dv)
    return q, k, v.transpose(-1, -2).contiguous().transpose(-1, -2)


@pytest.mark.parametrize("dqk,dv", [(192, 128), (256, 256)])
@pytest.mark.parametrize("make", [
    lambda dqk, dv: _pair(dqk=dqk, dv=dv, dtype=torch.float32),
    _pair_expanded, _pair_off_grid, _pair_head_dim_strided,
], ids=["float32", "zero-stride", "pointer-off-grid", "head-dim-strided"])
def test_other_mla_and_dh_256_inputs_go_to_the_simple_kernel(make, dqk, dv):
    assert fl.flash_kernel_for(*make(dqk, dv)) == "simple"


@pytest.mark.parametrize("dqk,dv", [(256, 128), (128, 192), (192, 64)])
def test_other_unequal_head_dims_are_refused(dqk, dv):
    """Only MLA's (192, 128) of the unequal pairs is taken, by either
    kernel; the Hopper kernel's pairs do not widen the check."""
    with pytest.raises(ValueError, match="head dim"):
        fl.check_shapes(*(t.shape for t in _pair(dqk=dqk, dv=dv)))
    assert fl.flash_kernel_for(*_pair(dqk=dqk, dv=dv)) == "simple"


def test_mla_prompt_pass_takes_the_hopper_kernel(monkeypatch):
    """The q, k, v that a bf16 MLA layer's prompt pass hands the flash
    route at deepseek-v2's head dims (q = cat(q_nope, q_rope), k =
    cat(k_nope, the shared rope key expanded), v from the latents) are
    inputs the Hopper kernel takes."""
    H, d, S = 4, 256, 9
    dims = tattn.MLADims(q_lora=32, kv_lora=16)
    gen = torch.Generator().manual_seed(6)
    params = {k: v.to(BF16) for k, v in
              tattn.init_mla(gen, d, H, dims).items()}
    x = torch.randn(1, S, d, generator=gen).to(BF16)
    seen = []

    def spy(q, k, v):
        seen.append((fl.flash_kernel_for(q, k, v), q.shape[-1], v.shape[-1],
                     k.is_contiguous()))
        return fa.flash_attention_ref(q, k, v)

    monkeypatch.setattr(tattn, "flash_attention", spy)
    tattn.mla(params, x, torch.arange(S)[None], H=H, dims=dims)
    assert seen == [("sm90", 192, 128, True)]


def test_dh_256_mqa_prompt_pass_takes_the_hopper_kernel(monkeypatch):
    """recurrentgemma's local layer: the q, k, v of a bf16 ``gqa`` prompt
    pass with 10 query heads over one kv head at head dim 256 and a
    window are inputs the Hopper kernel takes."""
    H, K, dh, d, S = 10, 1, 256, 128, 9
    gen = torch.Generator().manual_seed(8)
    params = {name: torch.randn(d, n, generator=gen).to(BF16)
              for name, n in (("wq", H * dh), ("wk", K * dh),
                              ("wv", K * dh))}
    params["wo"] = torch.randn(H * dh, d, generator=gen).to(BF16)
    x = torch.randn(1, S, d, generator=gen).to(BF16)
    seen = []

    def spy(q, k, v):
        seen.append(fl.flash_kernel_for(q, k, v))
        return fa.flash_attention_ref(q, k, v)

    monkeypatch.setattr(tattn, "flash_attention", spy)
    tattn.gqa(params, x, torch.arange(S)[None], H=H, K=K, dh=dh, window=16)
    assert seen == ["sm90"]
