"""The readers of the port's own spans and counters, each on a fake
``nafp_tpu_torch.utils.profiling.snapshot()``: the share of the window
in %, None where the port records no such span or counter, and None from
a port that has no ``snapshot`` at all."""
import sys
import types

import pytest

from portbench import registry

WINDOW_S = 20.0
# metric -> (cell, "spans" or "counts", name, field)
READS = {
    "query.assemble_pct": ("l2-icassp", "spans", "query.assemble",
                           "total_s"),
    "query.rerank_call_pct": ("l2-icassp", "spans", "query.rerank",
                              "total_s"),
    "query.rerank_wait_pct": ("l2-icassp", "spans", "query.rerank_wait",
                              "total_s"),
    "query.index_wait_pct": ("l2-icassp", "spans", "index.wait", "total_s"),
    "ingest.loader_wait_pct": ("l2-ingest", "spans", "loader.wait",
                               "total_s"),
    "ingest.decode_pct": ("l2-ingest", "counts", "loader.decode_s", None),
    "ingest.call_setup_pct": ("l2-ingest", "spans", "generate.setup",
                              "total_s"),
    "ingest.encoder_wait_pct": ("l2-ingest", "spans", "generate.wait",
                                "total_s"),
    "train.augment_stream_pct": ("lamb640-train", "spans", "train.augment",
                                 "device_s"),
    "train.forward_stream_pct": ("lamb640-train", "spans", "train.forward",
                                 "device_s"),
    "train.backward_stream_pct": ("lamb640-train", "spans",
                                  "train.backward", "device_s"),
    "train.optimizer_stream_pct": ("lamb640-train", "spans",
                                   "train.optimizer", "device_s"),
}


def _ctx():
    return types.SimpleNamespace(window_s=WINDOW_S)


def _snapshot(monkeypatch, snap):
    from nafp_tpu_torch.utils import profiling
    monkeypatch.setattr(profiling, "snapshot", lambda: snap)


def _fake(kind, name, field):
    """Every field of every span distinct, so a reader that takes the
    wrong one reads another number."""
    spans = {n: {"n": 3, "total_s": 6.0, "device_s": 1.0}
             for n in ("other.a", "other.b")}
    counts = {"other.c": 7.0}
    if kind == "spans":
        spans[name] = {"n": 4, "total_s": 5.0, "device_s": 2.0}
    else:
        counts[name] = 3.0
    return {"spans": spans, "counts": counts}


@pytest.mark.parametrize("metric", sorted(READS))
def test_reader_reads_its_span_or_counter(monkeypatch, metric):
    cell, kind, name, field = READS[metric]
    entry = next(m for m in registry.benchmark()["per_layer"]
                 if m["name"] == metric)
    assert entry["workloads"] == [cell] and entry["unit"] == "%"
    assert entry["source"] == ("program_counter" if kind == "counts"
                               else "program_span")
    read = registry.metric_reader(metric)
    _snapshot(monkeypatch, _fake(kind, name, field))
    want = {"total_s": 5.0, "device_s": 2.0, None: 3.0}
    assert read(_ctx()) == pytest.approx(100.0 * want[field] / WINDOW_S)
    _snapshot(monkeypatch, _fake("counts" if kind == "spans" else "spans",
                                 "other.d", None))
    assert read(_ctx()) is None
    if field == "device_s":              # a span recorded off the card
        snap = _fake(kind, name, field)
        snap["spans"][name]["device_s"] = None
        _snapshot(monkeypatch, snap)
        assert read(_ctx()) is None


def test_index_host_is_the_search_less_its_waits(monkeypatch):
    entry = next(m for m in registry.benchmark()["per_layer"]
                 if m["name"] == "query.index_host_pct")
    assert entry["workloads"] == ["l2-icassp"]
    assert entry["source"] == "program_span"
    read = registry.metric_reader("query.index_host_pct")
    snap = _fake("spans", "index.search", "total_s")
    _snapshot(monkeypatch, snap)
    assert read(_ctx()) == pytest.approx(100.0 * 5.0 / WINDOW_S)
    snap["spans"]["index.wait"] = {"n": 2, "total_s": 3.5, "device_s": None}
    assert read(_ctx()) == pytest.approx(100.0 * 1.5 / WINDOW_S)
    _snapshot(monkeypatch, _fake("spans", "index.wait", "total_s"))
    assert read(_ctx()) is None


def test_readers_return_none_from_a_port_without_a_snapshot(monkeypatch):
    bare = types.ModuleType("nafp_tpu_torch.utils.profiling")
    monkeypatch.setitem(sys.modules, "nafp_tpu_torch.utils.profiling", bare)
    for metric in [*READS, "query.index_host_pct"]:
        assert registry.metric_reader(metric)(_ctx()) is None, metric
