"""The IVF-PQ re-rank cell on the CPU: ``ivfpq-rr-icassp`` found from its
own files and run end to end through ``run.measure``, traced and
untraced, correct; not correct with a planted fault (a shortlist id
altered) or with a control in the port's place (the refine in TF32, no
re-score, decoded rows in fp8); its set-up refusing an index built
otherwise than stated; and the readers of its new per-layer metrics on a
fake snapshot.
"""
import os
import sys
import types

import pytest
import torch

from portbench import control_pq, control_rr, registry, run, work_rr

CPU = torch.device("cpu")
SEED = 2 ** 31 + 23456              # more than 32 signed bits hold
SIZES = {"model": {"FRONT_HIDDEN_CH": [8, 8, 16, 16, 32, 32, 64, 128],
                   "MIXED_PRECISION": False},
         "db": {"n_songs": 20, "song_sec": 10, "n_dummy": 2000}}
CELL = "ivfpq-rr-icassp"
BENCH = registry.benchmark()
CHECKS = {"enc_gap", "answer_gap", "pq_gap", "probe_miss", "code_gap",
          "coarse_gap", "books_gap", "refine_gap"}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def test_cell_found_from_its_own_files():
    cell = registry.Cell(BENCH, CELL)
    assert cell.config["name"] == "nnfp-icassp-ivfpq-rr"
    assert cell.config["index"]["type"] == "ivfpq-rr"
    assert cell.traffic["runner"] == "query_pq_rr"
    assert os.path.exists(os.path.join(registry.HERE, "runners",
                                       "query_pq_rr.py"))
    assert set(cell.limits) == CHECKS
    assert {m["name"] for m in cell.end_to_end} == {
        "query_clips_per_s", "query_p95_ms", "setup_s"}
    layer = {m["name"] for m in cell.per_layer}
    assert {"ivfpq.refine_pct", "ivfpq.refine_roofline_pct"} <= layer
    assert not layer & {"ivfpq.mfu", "ivfpq.search_roofline_pct"}


def _run(traced=False, **kw):
    cell = registry.Cell(BENCH, CELL)
    return run.measure(cell, SEED, 1.0, traced, CPU, {"sizes": SIZES, **kw})


def _failed(checks):
    return {n for n, c in checks.items() if not c["value"] <= c["limit"]}


@pytest.mark.parametrize("traced", [False, True])
def test_sound_run_is_correct(traced):
    line = _run(traced)
    assert line["correct"], line["checks"]
    assert set(line["checks"]) == CHECKS
    assert line["attempted"] > 0 and line["failed"] == 0
    cell = registry.Cell(BENCH, CELL)
    if traced:        # shares of the card's time are left out on the CPU
        assert set(line["metrics"]) <= {m["name"] for m in cell.per_layer}
    else:
        assert set(line["metrics"]) == {"query_clips_per_s", "query_p95_ms",
                                        "setup_s"}


def test_altered_shortlist_is_not_correct(monkeypatch):
    """One id of every block's shortlist moved to another row where the
    scan's merge produces it."""
    from nafp_tpu_torch.search import index
    plain = index._merge_topk

    def merge(*a):
        v, i = plain(*a)
        i = i.clone()
        i[:, 0] = (i[:, 0] + 7) % 1000
        return v, i
    monkeypatch.setattr(index, "_merge_topk", merge)
    line = _run()
    assert not line["correct"]
    assert "pq_gap" in _failed(line["checks"])


@pytest.mark.parametrize("reading,kind,caught", [
    (control_rr.reading, "rr_tf32", "refine_gap"),
    (control_rr.reading, "rr_none", "refine_gap"),
    (control_pq.reading, "pq_fp8", "pq_gap")],
    ids=["rr_tf32", "rr_none", "pq_fp8"])
def test_control_is_not_correct(reading, kind, caught):
    cell = registry.Cell(BENCH, CELL)
    assert caught in _failed(reading(cell, SEED, kind, 1.0, CPU, SIZES))


def test_port_reading_is_correct():
    cell = registry.Cell(BENCH, CELL)
    assert not _failed(control_rr.reading(cell, SEED, "port", 1.0, CPU,
                                          SIZES))


@pytest.mark.parametrize("index,match", [
    ({"type": "ivfpq"}, "without its refine"),
    ({"shortlist_factor": 2}, "the refine saw")],
    ids=["no-refine", "other-width"])
def test_index_other_than_stated_fails_the_setup(index, match):
    with pytest.raises(ValueError, match=match):
        _run(sizes={**SIZES, "index": index})


# -- the readers of the new metrics ------------------------------------------
WINDOW_S = 20.0
WORK = {"n_rows": 619500, "d": 128, "k": 20}
BLOCKS = [(1, 128), (19, 128), (5, 80)]       # (sl, clips) per search call


def _ctx(kind="NVIDIA H100 80GB HBM3"):
    return types.SimpleNamespace(window_s=WINDOW_S, kind=kind, work=WORK,
                                 counts={"blocks": BLOCKS})


def _snapshot(monkeypatch, spans, counts):
    from nafp_tpu_torch.utils import profiling
    monkeypatch.setattr(profiling, "snapshot",
                        lambda: {"spans": spans, "counts": counts})


def _span(device_s):
    return {"n": 3, "total_s": 9.0, "device_s": device_s}


def test_refine_share_reader(monkeypatch):
    read = registry.metric_reader("ivfpq.refine_pct")
    spans = {"ivfpq.search": _span(5.0), "ivfpq.scan": _span(0.5),
             "ivfpq.refine": _span(2.0)}
    _snapshot(monkeypatch, spans, {})
    assert read(_ctx()) == pytest.approx(100.0 * 2.0 / WINDOW_S)
    spans["ivfpq.refine"] = _span(None)               # off the card
    assert read(_ctx()) is None
    del spans["ivfpq.refine"]                         # the parent's port
    assert read(_ctx()) is None


def test_refine_roofline_reader(monkeypatch):
    read = registry.metric_reader("ivfpq.refine_roofline_pct")
    nq = sum(n * sl for sl, n in BLOCKS)
    rows = 80.0 * nq
    _snapshot(monkeypatch, {"ivfpq.refine": _span(0.5)},
              {"ivfpq.refine_rows": rows})
    nbytes = rows * (4 * 128 + 4 + 4) + nq * (4 * 128 + 20 * (4 + 4))
    assert work_rr.refine_bytes(rows, nq, 128, 20) == nbytes
    assert read(_ctx()) == pytest.approx(100.0 * nbytes / 3.35e12 / 0.5)
    assert read(_ctx("cpu")) is None
    _snapshot(monkeypatch, {"ivfpq.refine": _span(0.5)}, {})
    assert read(_ctx()) is None
    _snapshot(monkeypatch, {}, {"ivfpq.refine_rows": rows})
    assert read(_ctx()) is None


def test_readers_return_none_from_a_port_without_a_snapshot(monkeypatch):
    bare = types.ModuleType("nafp_tpu_torch.utils.profiling")
    monkeypatch.setitem(sys.modules, "nafp_tpu_torch.utils.profiling", bare)
    for name in ("ivfpq.refine_pct", "ivfpq.refine_roofline_pct"):
        assert registry.metric_reader(name)(_ctx()) is None, name
