"""``IVFPQIndex.search``'s spans and counters on the CPU, at tiny sizes:

- under ``torch.profiler.profile`` a search records ``ivfpq.search``,
  ``ivfpq.probe``, one ``ivfpq.decode`` and one ``ivfpq.scan`` per DB
  chunk, and the counter ``ivfpq.probed_rows``; a one-query search takes
  the gathered route and counts ``ivfpq.pruned``, a batched one does not;
- ``ivfpq.probed_rows`` equals a direct count: for each of the caller's
  query rows (a multi-block search's pad rows left out), the real rows of
  the ``nprobe`` lists the coarse probe picks;
- with no profiler nothing is recorded, and the results are bit-equal to
  the traced search's.
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from nafp_tpu_torch.search import index as P
from nafp_tpu_torch.utils import profiling

CPU = torch.device("cpu")
D, NLIST, M, NPROBE = 16, 16, 8, 3


@pytest.fixture(autouse=True)
def _fresh_tracer():
    profiling.reset()
    yield
    profiling.reset()


@pytest.fixture(scope="module")
def built():
    rng = np.random.default_rng(5)
    db = rng.standard_normal((1500, D)).astype(np.float32)
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    idx = P.IVFPQIndex(d=D, nlist=NLIST, m=M, nbits=4, nprobe=NPROBE,
                       device=CPU)
    idx.train(db, kmeans_iters=3, seed=11)
    idx.add(db)
    q = db[rng.choice(len(db), 70)] \
        + 0.05 * rng.standard_normal((70, D)).astype(np.float32)
    return idx, db, q


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, profiling.snapshot()


def _direct_probed_rows(idx, db, q):
    """Σ over query rows of the real rows in the lists its probe picks
    (top ``nprobe`` by f32 q · centroid, ties to the lower list)."""
    assign = P.assign_to_centroids(db, idx.centroids)
    per_list = np.bincount(assign, minlength=idx.nlist)
    sims = torch.from_numpy(q) @ idx.centroids.T
    _, probes = P.topk_low_index(sims, idx.nprobe)
    return int(per_list[probes.numpy()].sum())


@pytest.mark.parametrize("block", [512, 32], ids=["one-block", "padded"])
def test_spans_and_counters_recorded(built, block):
    idx, db, q = built
    (_, _), snap = _traced(lambda: idx.search(q, 5, block=block,
                                              chunk_rows=1024))
    spans, counts = snap["spans"], snap["counts"]
    n_chunks = -(-idx.n_pad // 1024)
    assert n_chunks > 1
    assert spans["ivfpq.search"]["n"] == 1
    assert spans["ivfpq.probe"]["n"] == 1
    assert spans["ivfpq.decode"]["n"] == n_chunks
    assert spans["ivfpq.scan"]["n"] == n_chunks
    assert spans["index.search"]["n"] == 1
    for name in ("ivfpq.search", "ivfpq.probe", "ivfpq.decode",
                 "ivfpq.scan"):
        assert spans[name]["device_s"] is None        # no card here
    assert counts["ivfpq.probed_rows"] == _direct_probed_rows(idx, db, q)
    assert "ivfpq.pruned" not in counts


def test_one_query_takes_the_gathered_route_and_counts_it(built):
    idx, db, q = built
    (_, _), snap = _traced(lambda: idx.search(q[:1], 5))
    assert snap["counts"]["ivfpq.pruned"] == 1
    assert snap["counts"]["ivfpq.probed_rows"] == _direct_probed_rows(
        idx, db, q[:1])


def test_untraced_search_records_nothing_and_is_bit_equal(built):
    idx, _, q = built
    plain = idx.search(q, 5, block=32, chunk_rows=1024)
    assert profiling.snapshot() == {"spans": {}, "counts": {}}
    traced, _ = _traced(lambda: idx.search(q, 5, block=32, chunk_rows=1024))
    for a, b in zip(plain, traced):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
