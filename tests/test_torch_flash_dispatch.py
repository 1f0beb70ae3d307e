"""Which flash-attention kernel takes which input, decided on the CPU.

``kernels.attention.flash.flash_kernel_for`` is a pure function of
dtype, shapes, strides and pointer alignment: the Hopper kernel
(``csrc/flash_sm90.cu``, TMA + ``wgmma``) takes bfloat16 q, k, v on
TMA's 16-byte grid at MLA's (q·k, v) head dims (192, 128) and at every
equal head dim whose row is a multiple of 16 bytes (a multiple of 8 up
to 256, padded to a tile of 16, 32, 64, 128 or 256), the float32 Hopper
kernel
(``csrc/flash_sm90_f32.cu``, TMA + TF32 ``mma.sync``) float32 ones on
the same grid at MLA's pair and equal multiples of 4 (tiles of 32, 64,
128, 256), and the simple kernel (``csrc/flash.cu``) what TMA cannot
describe: a head dim that is not contiguous, a zero or off-grid stride,
a misaligned pointer, a row that is not a multiple of 16 bytes (bf16
dh 100, float32 dh 30).  The kernels run only on the card
(``tests/test_torch_cuda.py``); here the choice, the tiles, the build
registry and the counters are checked without one.
"""

import itertools
import re

import pytest
import torch

from repro_torch.kernels import LAUNCH_COUNTERS, _build
from repro_torch.kernels import attention as fa
from repro_torch.kernels.attention import flash as fl
from repro_torch.models import attention as tattn

BF16 = torch.bfloat16
F32 = torch.float32


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
    # float32 off the grid: a row of 3*128 + 2 float32
    lambda: _fused(1, 40, 1, 1, 128, 3 * 128 + 2, dtype=F32),
    # head-dim rows that are not a multiple of 16 bytes
    lambda: _qkv(dh=100), lambda: _qkv(dh=30, dtype=F32),
    lambda: _qkv(dh=4), lambda: _qkv(dh=250, dtype=F32),
    _mixed_dtypes,
    _head_dim_not_contiguous,                   # stride(-1) != 1
    _shared_kv_heads,                           # a zero stride
    # a row of 3*64 + 4 columns: 392-byte strides, off the 16-byte grid
    lambda: _fused(1, 40, 1, 1, 64, 3 * 64 + 4),
    # strides on the grid, pointers 8 bytes off it
    lambda: _fused(1, 40, 1, 1, 64, 3 * 64 + 8, offset=4),
], ids=["float32-dh128", "dh100", "float32-dh30", "dh4", "float32-dh250",
        "mixed-dtypes", "head-dim-strided", "zero-stride",
        "stride-off-grid", "pointer-off-grid"])
def test_other_inputs_go_to_the_simple_kernel(make):
    assert fl.flash_kernel_for(*make()) == "simple"


@pytest.mark.parametrize("dh,dtype,route", [
    # head dims off the four tiles' own: the smoke configs' 16 and 32,
    # 48, phi-3-mini's 96, in bfloat16 and float32
    (16, BF16, "sm90"), (32, BF16, "sm90"), (48, BF16, "sm90"),
    (96, BF16, "sm90"), (96, F32, "sm90_f32"),
    # phi-2's 80, the grid's smallest rows, and dims between the tiles
    (80, BF16, "sm90"), (8, BF16, "sm90"), (136, BF16, "sm90"),
    (200, BF16, "sm90"), (248, BF16, "sm90"), (192, BF16, "sm90"),
    (4, F32, "sm90_f32"), (16, F32, "sm90_f32"), (36, F32, "sm90_f32"),
    (80, F32, "sm90_f32"), (100, F32, "sm90_f32"), (252, F32, "sm90_f32"),
], ids=["dh16", "dh32", "dh48", "dh96", "float32-dh96", "dh80", "dh8",
        "dh136", "dh200", "dh248", "dh192", "float32-dh4", "float32-dh16",
        "float32-dh36", "float32-dh80", "float32-dh100", "float32-dh252"])
def test_hopper_kernels_take_head_dims_padded_to_their_tiles(dh, dtype,
                                                            route):
    assert fl.flash_kernel_for(*_qkv(2, 65, 8, 2, dh, dtype)) == route


@pytest.mark.parametrize("dtype,step", [(BF16, 8), (F32, 4)])
def test_route_rule_over_every_head_dim(dtype, step):
    """Every equal head dim 1..256 of a contiguous q, k, v: the Hopper
    kernel of the type exactly where the row is a multiple of 16 bytes;
    the simple kernel elsewhere and past 256 (which ``check_shapes``
    refuses)."""
    hopper = "sm90" if dtype == BF16 else "sm90_f32"
    for dh in range(1, fl.MAX_DH + 9):
        want = hopper if dh % step == 0 and dh <= fl.MAX_DH else "simple"
        assert fl.flash_kernel_for(*_qkv(1, 3, 2, 1, dh, dtype)) == want, dh
        assert fl.sm90_head_dims(dtype, dh, dh) == (want == hopper)


@pytest.mark.parametrize("dtype,dh,tile", [
    (BF16, 8, 16), (BF16, 16, 16), (BF16, 24, 32), (BF16, 32, 32),
    (BF16, 40, 64), (BF16, 64, 64), (BF16, 72, 128),
    (BF16, 80, 128), (BF16, 96, 128), (BF16, 128, 128), (BF16, 136, 256),
    (BF16, 192, 256), (BF16, 256, 256),
    (F32, 4, 32), (F32, 16, 32), (F32, 32, 32), (F32, 36, 64),
    (F32, 64, 64), (F32, 80, 128), (F32, 96, 128), (F32, 132, 256),
    (F32, 256, 256)])
def test_padded_head_dim_runs_in_the_smallest_tile_that_holds_it(dtype, dh,
                                                                 tile):
    assert fl.sm90_tile(dtype, dh, dh) == (tile, tile)
    assert fl.sm90_tile(dtype, 192, 128) == fl.MLA_HEAD_DIMS


def test_tiles_match_the_sources_dispatch():
    """The tiles the route reports are the ones each source instantiates
    and dispatches to: bfloat16 MIN_TILE (16) / 32 / 64 / 128 / 256
    (multiples of 8), float32 SMALL_TILE (32) / 64 / 128 / 256 (multiples
    of 4), MLA's pair in both."""
    bf16 = _build.SOURCES["flash_sm90"].read_text()
    f32 = _build.SOURCES["flash_sm90_f32"].read_text()
    least = int(re.search(r"constexpr int MIN_TILE = (\d+);",
                          bf16).group(1))
    assert fl.SM90_TILES[0] == least == 16
    for tile in fl.SM90_TILES[:2]:
        assert (f"if (MIN_TILE <= {tile} && dh <= {tile}) "
                f"FLASH_SM90_RUN({tile}, {tile}, true)") in bf16
    for tile in fl.SM90_TILES[2:-1]:
        assert (f"if (dh <= {tile}) FLASH_SM90_RUN({tile}, {tile}, true)"
                in bf16)
    assert "dh % 8 != 0" in bf16 and "dh % 4 != 0" in f32
    small = int(re.search(r"constexpr int SMALL_TILE = (\d+);",
                          f32).group(1))
    assert fl.SM90_F32_TILES[0] == small == 32
    for tile in fl.SM90_F32_TILES[1:-1]:
        assert (f"if (dh <= {tile}) FLASH_F32_RUN({tile}, {tile}, true)"
                in f32)
    # the tiles' own head dims, unpadded: MLA's pair among them
    for run, text in (("FLASH_SM90_RUN", bf16), ("FLASH_F32_RUN", f32)):
        for dqk, dv in ((64, 64), (128, 128), fl.MLA_HEAD_DIMS, (256, 256)):
            assert (f"if (dh == {dqk} && dv == {dv}) {run}({dqk}, {dv}, "
                    f"false)") in text


@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("H,K", [(8, 8), (8, 2), (32, 4), (12, 2)])
@pytest.mark.parametrize("B,S", [(1, 1), (2, 65), (1, 1024)])
def test_float32_hopper_kernel_takes_head_dims_64_and_128(dh, H, K, B, S):
    assert fl.flash_kernel_for(*_qkv(B, S, H, K, dh, dtype=F32)) \
        == "sm90_f32"


@pytest.mark.parametrize("make", [
    lambda: _qkv(dh=30, dtype=F32),      # a 120-byte row
    lambda: _qkv(dh=50, dtype=F32),
    lambda: (_qkv(dtype=F32)[0].transpose(-1, -2).contiguous()
             .transpose(-1, -2), *_qkv(dtype=F32)[1:]),
    lambda: (_qkv(K=1, dtype=F32)[0],
             *(t.expand(1, 40, 2, 64) for t in _qkv(K=1, dtype=F32)[1:])),
    # a row of 3*64 + 2 float32: 776-byte strides, off the 16-byte grid
    lambda: _fused(1, 40, 1, 1, 64, 3 * 64 + 2, dtype=F32),
    # strides on the grid, pointers 8 bytes off it
    lambda: _fused(1, 40, 1, 1, 64, 3 * 64 + 4, offset=2, dtype=F32),
], ids=["dh30", "dh50", "head-dim-strided", "zero-stride", "stride-off-grid",
        "pointer-off-grid"])
def test_float32_off_the_hopper_grid_goes_to_the_simple_kernel(make):
    assert fl.flash_kernel_for(*make()) == "simple"


def test_float32_hopper_kernel_takes_fused_projection_views():
    """A fused float32 qkv projection's views: strides of 4 * 64 + 4
    elements, pointers 16 bytes in, on TMA's grid."""
    q, k, v = _fused(2, 77, 4, 2, 64, 8 * 64 + 4, offset=4, dtype=F32)
    assert not q.is_contiguous()
    assert fl.flash_kernel_for(q, k, v) == "sm90_f32"


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
    for kernel in (None, "sm90", "sm90_f32", "simple"):
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


def test_build_registers_the_float32_hopper_source_for_sm90a():
    src = _build.SOURCES["flash_sm90_f32"]
    assert src.name == "flash_sm90_f32.cu" and src.exists()
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    text = src.read_text()
    # chip_smoke.py and the profiler match kernels on this substring
    assert "flash_attention_kernel_sm90_f32" in text
    for ptx in ("cp.async.bulk.tensor", "mbarrier.try_wait",
                "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32",
                "cvt.rna.tf32.f32", "CU_TENSOR_MAP_DATA_TYPE_FLOAT32"):
        assert ptx in text
    # one precision a build: scripts/flash_f32_variants.py rewrites it
    assert len(re.findall(r"constexpr int PRECISION = [012];", text)) == 1
    assert _build.library_path("flash_sm90_f32").name.startswith(
        "libflash_sm90_f32")


def test_counters_name_both_flash_kernels():
    assert LAUNCH_COUNTERS["flash_attention"] is fl.flash_attention_cuda
    assert LAUNCH_COUNTERS["flash_attention_sm90"] is fl.launch_flash_sm90
    assert LAUNCH_COUNTERS["flash_attention_noncausal"] \
        is fl.noncausal_launches


def test_counter_names_the_float32_hopper_kernel():
    assert LAUNCH_COUNTERS["flash_attention_sm90_f32"] \
        is fl.launch_flash_sm90_f32
    assert isinstance(fl.launch_flash_sm90_f32.launches, int)
    assert "sm90_f32" in fl.KERNELS


@pytest.mark.parametrize("T", [1, 1000, 1600])
def test_route_does_not_depend_on_causality_or_key_length(T):
    """Cross-attention's q (B, S, H, dh) over k / v (B, T, K, dh) at
    another length goes where the same dtype, head dim and grid send a
    prompt over itself."""
    q = torch.zeros(1, 7, 8, 128, dtype=BF16)
    kv = torch.zeros(1, T, 2, 128, dtype=BF16)
    assert fl.flash_kernel_for(q, kv, kv) == "sm90"
    assert fl.flash_kernel_for(q.float(), kv.float(), kv.float()) \
        == "sm90_f32"


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
    itself goes: bfloat16 to the Hopper kernel, float32 to the float32
    Hopper kernel."""
    assert fl.flash_kernel_for(*_pair(1, 7, T, dqk=dqk, dv=dv)) == "sm90"
    assert fl.flash_kernel_for(*_pair(1, 7, T, dqk=dqk, dv=dv,
                                      dtype=F32)) == "sm90_f32"


def _pair_expanded(dqk, dv, dtype=BF16):
    q, k, v = _pair(K=1, dqk=dqk, dv=dv, dtype=dtype)
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
    # float32 with a zero stride: off the float32 kernel's grid
    lambda dqk, dv: _pair_expanded(dqk, dv, F32),
    _pair_expanded, _pair_off_grid, _pair_head_dim_strided,
], ids=["float32", "zero-stride", "pointer-off-grid", "head-dim-strided"])
def test_other_mla_and_dh_256_inputs_go_to_the_simple_kernel(make, dqk, dv):
    assert fl.flash_kernel_for(*make(dqk, dv)) == "simple"


@pytest.mark.parametrize("dqk,dv", [(192, 128), (256, 256)])
@pytest.mark.parametrize("H,K", [(128, 128), (8, 2), (10, 1)])
@pytest.mark.parametrize("B,S", [(1, 1), (2, 65), (1, 1024)])
def test_float32_hopper_kernel_takes_mla_and_dh_256(dqk, dv, H, K, B, S):
    assert fl.flash_kernel_for(*_pair(B, S, H=H, K=K, dqk=dqk, dv=dv,
                                      dtype=F32)) == "sm90_f32"


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


@pytest.mark.parametrize("layer", ["gqa-dh64", "mla", "local-dh256"])
def test_float32_prompt_passes_take_the_float32_hopper_kernel(
        monkeypatch, layer):
    """The views a float32 layer's prompt pass hands the flash route --
    ``gqa``'s projections at dh 64, MLA's cat(nope, rope) q and k and its
    v from the latents at 192 / 128, recurrentgemma's windowed MQA at
    dh 256 -- are inputs the float32 Hopper kernel takes."""
    gen = torch.Generator().manual_seed(9)
    seen = []

    def spy(q, k, v):
        seen.append((fl.flash_kernel_for(q, k, v), q.shape[-1],
                     v.shape[-1]))
        return fa.flash_attention_ref(q, k, v)

    monkeypatch.setattr(tattn, "flash_attention", spy)
    S = 9
    if layer == "mla":
        H, d = 4, 256
        dims = tattn.MLADims(q_lora=32, kv_lora=16)
        params = tattn.init_mla(gen, d, H, dims)
        x = torch.randn(1, S, d, generator=gen)
        tattn.mla(params, x, torch.arange(S)[None], H=H, dims=dims)
        assert seen == [("sm90_f32", 192, 128)]
        return
    H, K, dh, d, window = ((4, 2, 64, 256, 0) if layer == "gqa-dh64"
                           else (10, 1, 256, 128, 16))
    params = {name: torch.randn(d, n, generator=gen)
              for name, n in (("wq", H * dh), ("wk", K * dh),
                              ("wv", K * dh))}
    params["wo"] = torch.randn(H * dh, d, generator=gen)
    x = torch.randn(1, S, d, generator=gen)
    tattn.gqa(params, x, torch.arange(S)[None], H=H, K=K, dh=dh,
              window=window)
    assert seen == [("sm90_f32", dh, dh)]


@pytest.mark.parametrize("kernel,dtype,rate", [
    ("simple", "float32", "TF32_FLOPS"), ("simple", "bfloat16", "BF16_FLOPS"),
    ("sm90", "bfloat16", "BF16_FLOPS")])
def test_flash_bound_takes_the_cards_rate_for_the_inputs_type(kernel, dtype,
                                                              rate):
    """``chip_smoke.py``'s flash bound: each product once, at the card's
    rate for the inputs' type, whichever kernel runs it (the simple
    kernel's FFMA floor is reported beside it, not as its bound)."""
    import chip_smoke

    ops, got = chip_smoke.flash_ops(kernel, dtype, 1, 8, 1024, 1024, 32,
                                    32, True)
    assert got == getattr(chip_smoke, rate)
    assert ops == 8 * 1024 * 1024 * (32 + 32)


def test_flash_timing_retakes_a_pair_of_turns_that_spreads(monkeypatch):
    """A pair of turns whose larger exceeds the smaller 1.5 times (a
    profiler window that lost activities) is taken again; a spread that
    persists fails the check instead of entering the record."""
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "say", lambda *a, **k: None)
    again = iter([0.18, 0.17]).__next__
    assert chip_smoke.steady_turns([0.17693, 0.01469], again, "t") \
        == [0.18, 0.17]
    assert chip_smoke.steady_turns([0.1, 0.12], None, "t") == [0.1, 0.12]
    with pytest.raises(AssertionError, match="spread"):
        chip_smoke.steady_turns([0.1, 0.3],
                                itertools.cycle([0.1, 0.3]).__next__, "t")
