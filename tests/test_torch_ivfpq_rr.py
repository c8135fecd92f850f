"""IVF-PQ with an exact re-rank (``IVFPQIndex(refine=True)``, what
``get_index("ivfpq-rr")`` builds) against the plain float64 re-rank of
``portbench/reference/ivfpq_rr.py`` and the plain IVF-PQ search of
``portbench/reference/ivfpq.py``, at a small size on the CPU: the answers
are the exact top k of the port's own shortlist, the shortlist is the
IVF-PQ top 4·k, empty slots and ties keep the kernels' rules, and the
refine's span and counter record under a profiler only.
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from nafp_tpu_torch.search import index as P
from nafp_tpu_torch.utils import profiling
from portbench.reference import ivfpq as ref_pq
from portbench.reference import ivfpq_rr as ref_rr
from portbench.runners.query_pq_rr import tf32

CPU = torch.device("cpu")
D, K = 128, 20
WIDTH = 4 * K                   # the shortlist the refine re-scores


def _unit(rng, n):
    x = rng.standard_normal((n, D)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _build(db, nprobe, seed=5):
    idx = P.IVFPQIndex(d=D, nlist=16, m=16, nbits=4, nprobe=nprobe,
                       refine=True, device=CPU)
    idx.train(db, kmeans_iters=4, seed=seed)
    idx.add(db)
    return idx


@pytest.fixture(scope="module")
def built():
    rng = np.random.default_rng(23)
    db = _unit(rng, 4096)
    q = db[rng.choice(len(db), 300)] \
        + 0.05 * rng.standard_normal((300, D)).astype(np.float32)
    return _build(db, nprobe=4), db, q


def _search(idx, q, monkeypatch, **kw):
    """The search's answers and the shortlist each refine saw (the real
    rows of each query block)."""
    seen = []
    plain = P._pq_refine

    def refine(qd, raw, best_i, *, k):
        seen.append(best_i.clone())
        return plain(qd, raw, best_i, k=k)
    monkeypatch.setattr(P, "_pq_refine", refine)
    scores, ids = idx.search(q, K, **kw)
    monkeypatch.setattr(P, "_pq_refine", plain)
    block = kw.get("block", 512)
    short = torch.cat([s[:min(block, len(q) - b * block)]
                       for b, s in enumerate(seen)])
    return scores, ids, short


def test_answers_are_the_exact_rerank_of_the_shortlist(built, monkeypatch):
    idx, db, q = built
    scores, ids, short = _search(idx, q, monkeypatch)
    assert short.shape == (len(q), WIDTH)
    qt, raw = torch.from_numpy(q), torch.from_numpy(db)
    ref_v, ref_i = ref_rr.refine(qt, raw, short, K)
    diff = ids != ref_i.numpy()
    # ids differ only at float64 near-ties
    exact = ref_rr.rescore(qt, raw, torch.from_numpy(ids))
    assert float((exact - ref_v).abs()[torch.from_numpy(diff)].max()
                 if diff.any() else 0.0) < 1e-6
    assert diff.mean() < 0.01
    np.testing.assert_allclose(scores, ref_v.numpy(), rtol=0, atol=1e-5)
    assert ref_rr.refine_gap(qt, raw, short, scores, ids) < 1e-5
    # the reference catches an answer out of order, and the refine's
    # product in TF32 (operands rounded to TF32, summed in f32)
    swapped = ids.copy()
    swapped[:, [0, 1]] = swapped[:, [1, 0]]
    assert ref_rr.refine_gap(qt, raw, short, scores, swapped) > 1e-4
    v32, i32 = P._pq_refine(tf32(qt), tf32(raw), short, k=K)
    assert ref_rr.refine_gap(qt, raw, short, v32, i32) > 2e-5


def test_shortlist_is_the_ivfpq_top_width(built, monkeypatch):
    """With the decode kept in f32, the shortlist the refine saw is the
    search's own top 4·k with the refine off, and reads pq_gap at f32
    rounding against the plain IVF-PQ search."""
    idx, db, q = built

    def add_coarse(resid, sub_list, centroids, lt):
        coarse = centroids[sub_list.clamp(min=0).long()]
        resid.view(-1, lt, resid.shape[1]).add_(coarse[:, None, :])
        return resid
    monkeypatch.setattr(P, "_add_coarse", add_coarse)
    _, _, short = _search(idx, q, monkeypatch)
    idx.refine = False
    try:
        _, top = idx.search(q, WIDTH)
    finally:
        idx.refine = True
    np.testing.assert_array_equal(short.numpy(), top)
    lists, codes = ref_pq.rows_of_store(idx.codes, idx.ids, idx.sub_list,
                                        idx.LIST_TILE, len(db))
    recon = ref_pq.decode(idx.centroids, idx.codebooks, lists, codes)
    qt = torch.from_numpy(q)
    assert ref_pq.pq_gap(qt, idx.centroids, recon, lists, idx.nprobe,
                         short) < 1e-6
    shifted = short.clone()
    shifted[4, 0] = (shifted[4, 0] + 1) % len(db)
    assert ref_pq.pq_gap(qt, idx.centroids, recon, lists, idx.nprobe,
                         shifted) > 1e-3


def test_empty_slots_where_the_probed_lists_are_short(monkeypatch):
    """256 rows in 16 lists, one probed: fewer rows than the shortlist's
    80 slots, often fewer than k; the empty slots read -1 / -inf."""
    rng = np.random.default_rng(7)
    db = _unit(rng, 256)
    idx = _build(db, nprobe=1)
    q = _unit(rng, 40)
    scores, ids, short = _search(idx, q, monkeypatch)
    lists, _ = ref_pq.rows_of_store(idx.codes, idx.ids, idx.sub_list,
                                    idx.LIST_TILE, len(db))
    per_list = torch.bincount(lists, minlength=idx.nlist)
    qt = torch.from_numpy(q)
    probed = P._pq_bias_list(qt, idx.centroids, nprobe=1) > P.NEG / 2
    rows = (probed.long() * per_list).sum(1).numpy()
    assert rows.max() < WIDTH and rows.min() < K
    np.testing.assert_array_equal((short >= 0).sum(1).numpy(), rows)
    valid = ids >= 0
    np.testing.assert_array_equal(valid.sum(1), np.minimum(rows, K))
    assert np.isneginf(scores[~valid]).all()
    assert np.isfinite(scores[valid]).all()
    assert ref_rr.refine_gap(qt, torch.from_numpy(db), short, scores,
                             ids) < 1e-5


@pytest.mark.parametrize("order", [[7, 10, 3, 12], [3, 10, 7, 12]],
                         ids=["higher-id-first", "lower-id-first"])
def test_ties_go_to_the_lower_slot(order):
    """Rows 3 and 7 are equal, so their scores tie: the one in the lower
    shortlist slot comes first, in the port and in the reference; an
    empty slot (-1) ranks below every row."""
    rng = np.random.default_rng(11)
    raw = torch.from_numpy(_unit(rng, 20))
    raw[7] = raw[3]
    q = raw[3:4] + 0.01
    best_i = torch.tensor([order + [-1]], dtype=torch.int32)
    v, i = P._pq_refine(q, raw, best_i, k=5)
    assert i[0, :2].tolist() == [order[0], order[2]]
    assert int(i[0, 4]) == -1 and float(v[0, 4]) == -np.inf
    ref_v, ref_i = ref_rr.refine(q, raw, best_i, 5)
    assert i.long().tolist() == ref_i.tolist()
    torch.testing.assert_close(v.double(), ref_v, rtol=0, atol=1e-6)


def test_refine_span_and_counter_record_under_a_profiler_only(built):
    """``ivfpq.refine`` once a query block, inside ``ivfpq.search``;
    ``ivfpq.refine_rows`` the caller's rows x 4·k; nothing untraced; the
    answers the same either way."""
    idx, _, q = built
    profiling.reset()
    plain = idx.search(q, K, block=128)
    snap = profiling.snapshot()
    assert "ivfpq.refine" not in snap["spans"]
    assert "ivfpq.refine_rows" not in snap["counts"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = idx.search(q, K, block=128)
    snap = profiling.snapshot()
    profiling.reset()
    for a, b in zip(plain, traced):
        np.testing.assert_array_equal(a, b)
    assert snap["spans"]["ivfpq.refine"]["n"] == 3     # 128 + 128 + 44
    assert snap["counts"]["ivfpq.refine_rows"] == len(q) * WIDTH
    events = prof.events()
    (search,) = [e.time_range for e in events if e.name == "ivfpq.search"]
    refines = [e.time_range for e in events if e.name == "ivfpq.refine"]
    assert len(refines) == 3
    assert all(search.start <= r.start and r.end <= search.end
               for r in refines)
    # without the refine, no refine is recorded
    idx.refine = False
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            idx.search(q, K)
    finally:
        idx.refine = True
    snap = profiling.snapshot()
    profiling.reset()
    assert "ivfpq.search" in snap["spans"]
    assert "ivfpq.refine" not in snap["spans"]
