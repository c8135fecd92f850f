"""``train.lamb_roofline_pct``: LAMB's least bytes at the configuration's
parameter count, and the share read from a trace by kernel name."""
import json
import os
import types

import pytest

from portbench import peaks, registry

CARD = "NVIDIA H100 80GB HBM3"
MODEL = json.load(open(os.path.join(registry.HERE, "configs",
                                    "nnfp-640-lamb.json")))["model"]
read = registry.metric_reader("train.lamb_roofline_pct")
reader = read.__globals__


def _ctx(kernel_s, steps=500):
    return types.SimpleNamespace(
        kind=CARD, window_s=20.0, counts={"steps": steps,
                                          "segments": 640 * steps},
        trace={"kernel_s": kernel_s}, work={"model": MODEL})


def test_entry_appended_for_the_train_cell():
    entry = next(e for e in registry.benchmark()["per_layer"]
                 if e["name"] == "train.lamb_roofline_pct")
    assert {k: v for k, v in entry.items() if k != "workloads"} == {
        "name": "train.lamb_roofline_pct", "unit": "%", "better": "higher",
        "source": "device_trace", "layer": "trainer",
        "moves": "train_segments_per_s"}
    assert "lamb640-train" in entry["workloads"]


def test_parameters_of_the_640_lamb_model():
    assert reader["n_params"](MODEL) == 16_939_008


def test_share_of_the_lamb_kernels_only():
    """28 B a parameter a step: 0.1416 ms a step at 3.35 TB/s."""
    least = 500 * 28 * 16_939_008 / peaks.peak(CARD, "hbm_bytes")
    assert least / 500 == pytest.approx(1.4158e-4, rel=1e-4)
    trace = {"void (anonymous namespace)::lamb_moments_kernel(...)": least,
             "void (anonymous namespace)::lamb_apply_kernel(...)": least,
             "void at::native::elementwise_kernel<128, 4>(...)": 9.0}
    assert read(_ctx(trace)) == pytest.approx(50.0)


def test_none_without_a_lamb_kernel():
    assert read(_ctx({"void at::native::elementwise_kernel<128, 4>(...)":
                      1.0})) is None
    assert read(_ctx({})) is None
    assert read(_ctx({"lamb_apply_kernel": 1.0}, steps=0)) is None
    assert read(types.SimpleNamespace(
        kind="cpu", window_s=20.0, counts={"steps": 5},
        trace={"kernel_s": {"lamb_apply_kernel": 1.0}},
        work={"model": MODEL})) is None
