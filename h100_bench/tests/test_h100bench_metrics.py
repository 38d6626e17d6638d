"""Each per-layer metric's reader on a synthetic traced segment whose
numbers are counted by hand, and the attribution of operations to layers."""

from __future__ import annotations

import pytest
from conftest import ROOT

import run as runner
from harness import cell as cells
from harness.card import HBM_BYTES_PER_S, PEAK_OPS_PER_S
from harness.layers import layer_of
from harness.profiling import DeviceWindow

OPS = [  # (name, start us, end us): two steps
    ("void row_gather_kernel<float>(...)", 0.0, 10.0),
    ("void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<...>", 10.0, 40.0),
    ("void (anonymous namespace)::tile_kernel<float4, SegKeys<true>, SumSink<float4>>", 40.0, 60.0),
    ("void (anonymous namespace)::rowwise_update_kernel<0>(...)", 60.0, 70.0),
    ("nvjet_tst_32x64_64x16_4x1_v_bz_NTN", 100.0, 300.0),
    ("Memcpy HtoD (Pinned -> Device)", 300.0, 320.0),
]


def segment():
    device = DeviceWindow(OPS, window_s=400e-6, busy_s=300e-6)
    # two traced steps; an untraced window of 250 us a step
    return runner.Segment(device, 2, 250e-6, {"wait": 1.5, "step": 0.5, "place": 0.25, "pack": 4.5},
                          {"lookup": 1e6, "sparse_update": 4e6},
                          {"bfloat16": 989e6, "float32": 67e6})


def test_layers_by_name():
    assert [layer_of(n) for n, _, _ in OPS] == [
        "lookup", "sparse_update", "sparse_update", "sparse_update", "dense", "copy"]
    assert layer_of("void at::native::_scatter_gather_elementwise_kernel<...>") == "sparse_update"


@pytest.mark.parametrize("name,expected", [
    ("host_wait_ms.train", 1.5),
    ("host_dispatch_ms.train", 0.75),
    # 1e6 bytes a step at 3.35 TB/s over 10 us of lookup in two steps
    ("lookup_roofline.train", 100 * (1e6 / HBM_BYTES_PER_S) / 5e-6),
    ("sparse_update_roofline.train", 100 * (4e6 / HBM_BYTES_PER_S) / 30e-6),
    ("dense_ms.train", 0.1),
    # 1 us of bf16 and 1 us of float32 at their peaks over the window's 250 us a step
    ("train_mfu", 100 * (989e6 / PEAK_OPS_PER_S["bfloat16"] + 67e6 / 67e12) / 250e-6),
    ("device_idle.train", 25.0),
    # 150 us busy a traced step over the window's 250 us a step
    ("device_busy_untraced.train", 60.0),
])
def test_each_reader(name, expected):
    reader = cells.load_module(ROOT / "h100_bench" / "metrics" / f"{name}.py", f"r_{name}")
    assert reader.read(segment()) == pytest.approx(expected, rel=1e-12)


def test_a_reader_with_nothing_to_read_returns_none():
    empty = runner.Segment(DeviceWindow([("nvjet", 0.0, 1.0)], 1e-6, 1e-6), 1, 0.0, {}, {}, {})
    for name in ("host_wait_ms.train", "host_dispatch_ms.train", "lookup_roofline.train",
                 "sparse_update_roofline.train", "train_mfu", "device_busy_untraced.train"):
        reader = cells.load_module(ROOT / "h100_bench" / "metrics" / f"{name}.py", f"n_{name}")
        assert reader.read(empty) is None


def test_breakdown_ranks_device_time_and_idle():
    device = DeviceWindow(OPS, 400e-6, 300e-6, [("cudaGraphLaunch", 5e-5), ("aten::copy_", 1e-5),
                                                ("cudaGraphLaunch", 2e-5)])
    b = device.breakdown()
    assert b["device_ops"][0] == ["nvjet_tst_32x64_64x16_4x1_v_bz_NTN", pytest.approx(2e-4)]
    assert b["idle_gaps"] == [["cudaGraphLaunch", pytest.approx(7e-5)], ["aten::copy_", 1e-5]]
