"""The IVF-PQ cell on the CPU: the plain reference against the port's
``IVFPQIndex`` at a small size; ``ivfpq-icassp`` run end to end through
``run.measure``, traced and untraced, correct; not correct with a planted
fault (a hit id shifted, one probe dropped, one stored code altered, the
build's k-means stopped after one step, the books trained on the raw
rows) or with a control one precision below the port (int8 codebooks,
float8 decoded rows) in its place; and the readers of its new per-layer
metrics on a fake snapshot.
"""
import sys
import types

import numpy as np
import pytest
import torch

from portbench import control_pq, registry, run, work_pq
from portbench.reference import ivfpq as ref_pq

CPU = torch.device("cpu")
SEED = 2 ** 31 + 12345              # more than 32 signed bits hold
SIZES = {"model": {"FRONT_HIDDEN_CH": [8, 8, 16, 16, 32, 32, 64, 128],
                   "MIXED_PRECISION": False},
         "db": {"n_songs": 20, "song_sec": 10, "n_dummy": 2000}}
CELL = "ivfpq-icassp"
BENCH = registry.benchmark()


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


# -- the reference against the port's index ----------------------------------
@pytest.fixture(scope="module")
def small_index():
    from nafp_tpu_torch.search import index as P
    rng = np.random.default_rng(3)
    db = rng.standard_normal((4096, 128)).astype(np.float32)
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    idx = P.IVFPQIndex(d=128, nlist=16, m=64, nprobe=4, device=CPU)
    idx.train(db, kmeans_iters=4, seed=9)
    idx.add(db)
    q = db[rng.choice(len(db), 200)] \
        + 0.1 * rng.standard_normal((200, 128)).astype(np.float32)
    lists, codes = ref_pq.rows_of_store(idx.codes, idx.ids, idx.sub_list,
                                        idx.LIST_TILE, len(db))
    return idx, db, q, lists, codes


def test_store_rows_read_back(small_index):
    from nafp_tpu_torch.search.index import assign_to_centroids
    idx, db, _, lists, codes = small_index
    np.testing.assert_array_equal(
        lists.numpy(), assign_to_centroids(db, idx.centroids))
    assert codes.shape == (len(db), 64) and int(codes.max()) < idx.ksub
    bad = idx.ids.clone()
    bad[torch.nonzero(bad >= 0)[0, 0]] = -1           # a row left out
    with pytest.raises(ValueError, match="exactly once"):
        ref_pq.rows_of_store(idx.codes, bad, idx.sub_list, idx.LIST_TILE,
                             len(db))


def test_probe_sets_are_the_top_lists_without_near_ties(small_index):
    idx, _, q, _, _ = small_index
    qt = torch.from_numpy(q)
    certain, possible = ref_pq.probe_sets(qt, idx.centroids, idx.nprobe)
    sims = torch.sort(qt.double() @ idx.centroids.double().T, dim=1,
                      descending=True)
    top = sims.indices[:, :idx.nprobe]
    want = torch.zeros_like(certain).scatter_(1, top, True)
    clear = sims.values[:, idx.nprobe - 1] - sims.values[:, idx.nprobe] > 1e-4
    assert int(clear.sum()) >= 190
    assert torch.equal(certain[clear], want[clear])
    assert torch.equal(possible[clear], want[clear])
    assert (certain <= want).all() and (want <= possible).all()
    # a list tied with the nprobe-th is possible and not certain
    c = idx.centroids.clone()
    kth = top[0, -1]
    other = next(i for i in range(idx.nlist) if not want[0, i])
    c[other] = c[kth]
    cert, poss = ref_pq.probe_sets(qt[:1], c, idx.nprobe)
    assert poss[0, other] and poss[0, kth]
    assert not cert[0, other] and not cert[0, kth]


def test_reference_agrees_with_the_port_in_f32(small_index, monkeypatch):
    """The port's search with its decode kept in f32 (not cast to bf16)
    reads pq_gap at f32 rounding, and its store code_gap at 0."""
    from nafp_tpu_torch.search import index as P
    idx, db, q, lists, codes = small_index

    def add_coarse(resid, sub_list, centroids, lt):
        coarse = centroids[sub_list.clamp(min=0).long()]
        resid.view(-1, lt, resid.shape[1]).add_(coarse[:, None, :])
        return resid
    monkeypatch.setattr(P, "_add_coarse", add_coarse)
    _, ids = idx.search(q, 20)
    recon = ref_pq.decode(idx.centroids, idx.codebooks, lists, codes)
    qt = torch.from_numpy(q)
    assert ref_pq.pq_gap(qt, idx.centroids, recon, lists, idx.nprobe,
                         ids) < 1e-6
    x = torch.from_numpy(db)
    assert ref_pq.code_gap(x, idx.centroids, idx.codebooks, idx.codebooks,
                           lists, codes) < 1e-12
    # the same answers judged against one probe more are caught
    assert ref_pq.pq_gap(qt, idx.centroids, recon, lists, idx.nprobe + 1,
                         ids) > 1e-3
    # a shifted id, and a code moved to another codeword, are caught
    shifted = ids.copy()
    shifted[5, 0] = (shifted[5, 0] + 1) % len(db)
    assert ref_pq.pq_gap(qt, idx.centroids, recon, lists, idx.nprobe,
                         shifted) > 1e-3
    moved = codes.clone()
    moved[7, 3] = (moved[7, 3] + 1) % idx.ksub
    assert ref_pq.code_gap(x, idx.centroids, idx.codebooks, idx.codebooks,
                           lists, moved) > 1e-6


def test_probe_miss_reads_the_port_probe(small_index):
    from nafp_tpu_torch.search import index as P
    idx, _, q, _, _ = small_index
    qt = torch.from_numpy(q)

    def probed(nprobe):
        return P._pq_bias_list(qt, idx.centroids, nprobe=nprobe) > P.NEG / 2
    assert ref_pq.probe_miss(qt, idx.centroids, idx.nprobe,
                             probed(idx.nprobe)) == 0.0
    for nprobe in (idx.nprobe - 1, idx.nprobe + 1):
        assert ref_pq.probe_miss(qt, idx.centroids, idx.nprobe,
                                 probed(nprobe)) > 0.9


def test_lloyd_gaps_are_zero_at_a_fixed_point_only(small_index):
    """Centroids at the means of the rows nearest them read ~0; one Lloyd
    step from a random draw of rows, or books fitted to other rows than
    the residuals, read far above a trained build."""
    from nafp_tpu_torch.search import index as P
    idx, db, _, lists, _ = small_index
    x = torch.from_numpy(db)
    trained = ref_pq.lloyd_gap(x, idx.centroids)
    fixed = P.kmeans(x.double(), idx.nlist, iters=100, seed=1)
    assert ref_pq.lloyd_gap(x, fixed) < 1e-12
    rough = P._lloyd_step(x, x[torch.randperm(len(x))[:idx.nlist]])
    assert ref_pq.lloyd_gap(x, rough) > 3 * trained
    books = ref_pq.books_lloyd_gap(x, idx.centroids, idx.codebooks, lists)
    raw = torch.stack([P.kmeans(x.view(-1, idx.m, idx.dsub)[:, mi]
                                .contiguous(), idx.ksub, iters=4, seed=mi)
                       for mi in range(idx.m)])
    assert ref_pq.books_lloyd_gap(x, idx.centroids, raw, lists) > 10 * books


# -- the cell end to end -----------------------------------------------------
def _run(traced=False, **kw):
    cell = registry.Cell(BENCH, CELL)
    return run.measure(cell, SEED, 1.0, traced, CPU,
                       {"sizes": SIZES, **kw})


def _failed(line):
    return {n for n, c in line["checks"].items()
            if not c["value"] <= c["limit"]}


@pytest.mark.parametrize("traced", [False, True])
def test_sound_run_is_correct(traced):
    line = _run(traced)
    assert line["correct"], line["checks"]
    assert set(line["checks"]) == {"enc_gap", "answer_gap", "pq_gap",
                                   "probe_miss", "code_gap", "coarse_gap",
                                   "books_gap"}
    assert line["attempted"] > 0 and line["failed"] == 0
    cell = registry.Cell(BENCH, CELL)
    if traced:        # shares of the card's time are left out on the CPU
        assert set(line["metrics"]) <= {m["name"] for m in cell.per_layer}
    else:
        assert set(line["metrics"]) == {"query_clips_per_s", "query_p95_ms",
                                        "setup_s"}


def _shift_hits(monkeypatch):
    """A segment hit shifted where the index produces it."""
    from nafp_tpu_torch.search import index
    plain = index.IVFPQIndex.search

    def search(self, q, k, *a, **kw):
        d, ids = plain(self, q, k, *a, **kw)
        ids = ids.copy()
        ids[:, 0] = (ids[:, 0] + 7) % self.ntotal
        return d, ids
    monkeypatch.setattr(index.IVFPQIndex, "search", search)


def _drop_probe(monkeypatch):
    """One probe dropped: the port's probe takes nprobe 39 of the
    configuration's 40."""
    from nafp_tpu_torch.search import index
    plain = index._pq_bias_list

    def bias(q, centroids, *, nprobe):
        return plain(q, centroids, nprobe=nprobe - 1)
    monkeypatch.setattr(index, "_pq_bias_list", bias)


def _alter_code(monkeypatch):
    """One stored code of one row moved to another codeword."""
    from nafp_tpu_torch.search import index
    plain = index.IVFPQIndex._publish

    def publish(self, codes, ids, sub_list):
        codes = codes.copy()
        row = int(np.flatnonzero(ids >= 0)[11])
        codes[row, 5] = (int(codes[row, 5]) + 1) % self.ksub
        plain(self, codes, ids, sub_list)
    monkeypatch.setattr(index.IVFPQIndex, "_publish", publish)


@pytest.mark.parametrize("fault,caught", [
    (_shift_hits, "pq_gap"), (_drop_probe, "probe_miss"),
    (_alter_code, "code_gap")], ids=["hit-shifted", "probe-dropped",
                                     "code-altered"])
def test_planted_fault_is_not_correct(monkeypatch, fault, caught):
    fault(monkeypatch)
    line = _run()
    assert not line["correct"]
    assert caught in _failed(line)


@pytest.mark.parametrize("kind,caught", [
    ("pq_int8", "code_gap"), ("pq_fp8", "pq_gap"), ("kmeans1", "books_gap"),
    ("raw_books", "books_gap")])
def test_control_and_build_fault_are_not_correct(kind, caught):
    cell = registry.Cell(BENCH, CELL)
    checks = control_pq.reading(cell, SEED, kind, 1.0, CPU, SIZES)
    failed = {n for n, c in checks.items() if not c["value"] <= c["limit"]}
    assert caught in failed


def test_index_other_than_stated_fails_the_setup():
    cell = registry.Cell(BENCH, CELL)
    with pytest.raises(ValueError, match="configuration states"):
        run.measure(cell, SEED, 1.0, False, CPU,
                    {"sizes": {**SIZES, "index": {"m": 32}}})


# -- the readers of the new metrics ------------------------------------------
WINDOW_S = 20.0
WORK = {"n_rows": 619500, "d": 128, "k": 20, "nlist": 256, "nprobe": 40,
        "m": 64, "ksub": 256, "n_pad": 635904, "list_tile": 128,
        "n_real": 619500}
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


@pytest.mark.parametrize("name", ["probe", "decode", "scan"])
def test_span_share_readers(monkeypatch, name):
    read = registry.metric_reader(f"ivfpq.{name}_pct")
    spans = {f"ivfpq.{o}": _span(0.5) for o in ("probe", "decode", "scan")}
    spans[f"ivfpq.{name}"] = _span(2.0)
    _snapshot(monkeypatch, spans, {})
    assert read(_ctx()) == pytest.approx(100.0 * 2.0 / WINDOW_S)
    spans[f"ivfpq.{name}"] = _span(None)              # off the card
    assert read(_ctx()) is None
    del spans[f"ivfpq.{name}"]                        # the parent's port
    assert read(_ctx()) is None


def test_roofline_reader(monkeypatch):
    read = registry.metric_reader("ivfpq.search_roofline_pct")
    rows = sum(n * sl for sl, n in BLOCKS)
    probed = 97000.0 * rows
    _snapshot(monkeypatch, {"ivfpq.search": _span(0.5)},
              {"ivfpq.probed_rows": probed})
    least = 0.0
    for sl, n in BLOCKS:
        nq = n * sl
        flops = 2.0 * 128 * 97000.0 * nq
        nbytes = (635904 * 64 + 4 * 635904 + 4 * 635904 / 128
                  + 4 * (256 * 128 + 256 * 128) + 4 * nq * 128 + 8 * nq * 20)
        least += max(flops / 989.4e12, nbytes / 3.35e12)
    assert read(_ctx()) == pytest.approx(100.0 * least / 0.5)
    assert work_pq.search_least_seconds(128, 97000.0 * 128, WORK, 989.4e12,
                                        3.35e12) > 0
    assert read(_ctx("cpu")) is None
    _snapshot(monkeypatch, {"ivfpq.search": _span(0.5)}, {})
    assert read(_ctx()) is None


def test_mfu_reader(monkeypatch):
    read = registry.metric_reader("ivfpq.mfu")
    _snapshot(monkeypatch, {}, {"ivfpq.probed_rows": 1e9})
    rerank = sum(2.0 * 128 * n * (sl * 20) * sl for sl, n in BLOCKS)
    want = 100.0 * (2.0 * 128 * 1e9 + rerank) / WINDOW_S / 989.4e12
    assert read(_ctx()) == pytest.approx(want)
    _snapshot(monkeypatch, {}, {})
    assert read(_ctx()) is None


def test_readers_return_none_from_a_port_without_a_snapshot(monkeypatch):
    bare = types.ModuleType("nafp_tpu_torch.utils.profiling")
    monkeypatch.setitem(sys.modules, "nafp_tpu_torch.utils.profiling", bare)
    for name in ("ivfpq.mfu", "ivfpq.search_roofline_pct", "ivfpq.probe_pct",
                 "ivfpq.decode_pct", "ivfpq.scan_pct"):
        assert registry.metric_reader(name)(_ctx()) is None, name
