"""The readers of the training attention's metrics on synthetic records:
``attention_kernel_share.train`` (the program's counters) and
``attention_core_device_ms.train`` (device ms under ``attention.core``
in the forward, its recomputation and its backward), each silent off the
card and on a program without the counters or the span (the parent of
the change that added them)."""

import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from perfbench import bench  # noqa: E402

ATT = "train.step/train.member/model.forward/model.attention"
BWD = "train.step/train.member/model.backward"
PATHS = {
    ATT: 80.0,
    f"{ATT}/attention.core": 20.0,
    f"{BWD}/model.attention[recompute]": 60.0,
    f"{BWD}/model.attention[recompute]/attention.core": 21.0,
    f"{BWD}/model.attention[grad]": 80.0,
    f"{BWD}/model.attention[grad]/attention.core[grad]": 59.0,
    f"{BWD}/model.ffn[grad]": 300.0,
}


def reader(name):
    return bench.load_module(REPO / "perfbench" / "metrics" / f"{name}.py",
                             f"test_attention_{name}").read


def record(platform="cuda", counters=None, paths=PATHS):
    return {"kind": "train", "platform": platform,
            "program": {"platform": platform,
                        "counters": {} if counters is None else counters,
                        "paths": {p: {"device_ms": ms, "idle_ms": 1.0,
                                      "calls": 1.0}
                                  for p, ms in paths.items()}}}


@pytest.mark.parametrize("kernel,plain,want", [(112, 0, 100.0),
                                               (84, 28, 75.0),
                                               (0, 30, 0.0)])
def test_kernel_share_is_kernel_calls_over_all(kernel, plain, want):
    counters = {k: v for k, v in (("attention.kernel_calls", kernel),
                                  ("attention.plain_calls", plain)) if v}
    assert reader("attention_kernel_share.train")(
        record(counters=counters)) == pytest.approx(want)


def test_kernel_share_silent_off_the_card_and_without_counters():
    read = reader("attention_kernel_share.train")
    counters = {"attention.plain_calls": 8}
    assert read(record("cpu", counters)) is None
    assert read(record(counters={"moe.slots": 4})) is None
    assert read({"kind": "serve"}) is None


def test_core_device_ms_sums_forward_recompute_and_grad():
    read = reader("attention_core_device_ms.train")
    assert read(record()) == pytest.approx(20.0 + 21.0 + 59.0)
    assert read(record("cpu")) is None
    assert read(record(paths={p: v for p, v in PATHS.items()
                              if "core" not in p})) is None
