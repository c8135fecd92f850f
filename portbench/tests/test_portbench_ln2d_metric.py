"""``train.ln2d_roofline_pct``: LayerNorm2d's least bytes at the
configuration's widths, and the share read from a trace by kernel name."""
import json
import os
import types

import pytest

from portbench import peaks, registry

CARD = "NVIDIA H100 80GB HBM3"
MODEL = json.load(open(os.path.join(registry.HERE, "configs",
                                    "nnfp-640-lamb.json")))["model"]
read = registry.metric_reader("train.ln2d_roofline_pct")
reader = read.__globals__


def _ctx(kernel_s, segments=6400):
    return types.SimpleNamespace(
        kind=CARD, window_s=20.0, counts={"segments": segments},
        trace={"kernel_s": kernel_s}, work={"model": MODEL})


def test_entry_appended_for_the_train_cell():
    entry = next(m for m in registry.benchmark()["per_layer"]
                 if m["name"] == "train.ln2d_roofline_pct")
    assert entry == {"name": "train.ln2d_roofline_pct", "unit": "%",
                     "better": "higher", "source": "device_trace",
                     "layer": "encoder", "moves": "train_segments_per_s",
                     "workloads": ["lamb640-train"]}


def test_least_bytes_of_the_640_lamb_encoder():
    """16 norms of 1,145,856 elements a segment in all (524,288 at the
    first, 1,024 at the last), 10 bf16 bytes each."""
    assert reader["least_bytes_per_segment"](MODEL) == 11_458_560
    f32 = dict(MODEL, MIXED_PRECISION=False)
    assert reader["least_bytes_per_segment"](f32) == 2 * 11_458_560


def test_share_of_the_ln2d_kernels_only():
    least = 6400 * 11_458_560 / peaks.peak(CARD, "hbm_bytes")
    trace = {"void (anonymous namespace)::ln2d_fwd_stats_kernel<8>(...)":
             least, "void (anonymous namespace)::ln2d_bwd_dx_kernel<8>(...)":
             least, "void at::native::reduce_kernel<512, 1>(...)": 9.0}
    assert read(_ctx(trace)) == pytest.approx(50.0)


def test_none_without_an_ln2d_kernel():
    assert read(_ctx({"void at::native::reduce_kernel<512, 1>(...)":
                      1.0})) is None
    assert read(_ctx({})) is None
    assert read(_ctx({"ln2d_fwd_norm_kernel": 1.0}, segments=0)) is None


def test_time_under_the_least_reads_over_100():
    """A kernel time shorter than the least time reads above 100 %: the
    bytes or the time would then be miscounted."""
    least = 6400 * 11_458_560 / peaks.peak(CARD, "hbm_bytes")
    assert read(_ctx({"ln2d_bwd_dx_kernel": 0.5 * least})) == \
        pytest.approx(200.0)
