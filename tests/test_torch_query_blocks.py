"""The query-block seam (``search/index.py``: ``query_blocks``,
``BlockSearch``) under every index kind of the port, on the CPU at tiny
sizes:

- a search in several blocks, its last block ragged (and so padded),
  equals the one-block search: ids equal, scores within 1e-6;
- an empty query gives ``(0, k)`` f32 scores and int32 ids;
- under a profiler a search copies to the host once per block
  (``index.wait``), IVF-PQ once more for its coverage.

The ``l2-sharded`` case is the former ``test_sharded_query_blocks`` of
``tests/test_torch_sharded_search.py``: its DB, queries and blocks.
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from nafp_tpu_torch.search import index as I
from nafp_tpu_torch.search import sharded as S
from nafp_tpu_torch.utils import profiling

CPU = torch.device("cpu")
D, K = 32, 5
N_Q, SPLIT, WHOLE = 300, 128, 512         # 128 + 128 + 44 rows, or one block
SHARDS = [CPU] * 8            # the former test's shard count


def _unit(n, seed):
    x = np.random.default_rng(seed).standard_normal((n, D)).astype(
        np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _trained(idx, db):
    idx.train(db, kmeans_iters=3, seed=3)
    idx.add(db)
    return idx


def _ivfpq(db):
    return _trained(I.IVFPQIndex(d=D, nlist=16, m=8, nbits=4, nprobe=4,
                                 device=CPU), db)


def _sq8(cls, db, **kw):
    idx = cls(d=D, **kw)
    idx.add(db)
    return idx


KINDS = {
    "l2-matmul": lambda db: I.FlatIndex(db, "l2", CPU),
    "l2-b1": lambda db: I.FlatIndex(db, "l2", CPU),
    "ip": lambda db: I.FlatIndex(db, "ip", CPU),
    "sq8": lambda db: _sq8(I.SQ8FlatIndex, db, device=CPU),
    "ivfpq": _ivfpq,
    "ivf-sq8": lambda db: _trained(
        I.IVFSQ8Index(d=D, nlist=16, nprobe=4, device=CPU), db),
    "l2-sharded": lambda db: S.ShardedFlatIndex(db, devices=SHARDS),
    "sq8-sharded": lambda db: _sq8(S.ShardedSQ8FlatIndex, db,
                                   devices=SHARDS),
    "ivf-sq8-sharded": lambda db: _trained(
        S.ShardedIVFSQ8Index(d=D, nlist=16, nprobe=4, devices=SHARDS), db),
}


@pytest.fixture(autouse=True)
def _fresh_tracer():
    profiling.reset()
    yield
    profiling.reset()


@pytest.mark.parametrize("kind", list(KINDS))
def test_query_blocks(kind, monkeypatch):
    if kind == "l2-sharded":
        rng = np.random.default_rng(0)
        db = rng.standard_normal((1024, D)).astype(np.float32)
        q = rng.standard_normal((N_Q, D)).astype(np.float32)
    else:
        db = _unit(1500, 1)
        q = db[np.random.default_rng(2).integers(0, len(db), N_Q)] \
            + 0.05 * _unit(N_Q, 3)
    if kind == "l2-b1":
        monkeypatch.setattr(I.FlatIndex, "PALLAS_MIN_ROWS", 1000)
    idx = KINDS[kind](db)
    if kind.startswith("l2-"):
        assert idx.block_rows(WHOLE) >= N_Q
        assert (kind == "l2-b1") == all(
            s._use_kernel() for s in getattr(idx, "shards", [idx]))

    v1, i1 = idx.search(q, K, block=WHOLE)
    with profile(activities=[ProfilerActivity.CPU]):
        v3, i3 = idx.search(q, K, block=SPLIT)
    assert v1.dtype == v3.dtype == np.float32
    assert i1.dtype == i3.dtype == np.int32
    assert v1.shape == i1.shape == (N_Q, K)
    np.testing.assert_array_equal(i3, i1)
    np.testing.assert_allclose(v3, v1, rtol=0, atol=1e-6)
    spans = profiling.snapshot()["spans"]
    assert spans["index.search"]["n"] == 1
    assert spans["index.wait"]["n"] == 3 + (kind == "ivfpq")

    v0, i0 = idx.search(q[:0], K)
    assert v0.shape == i0.shape == (0, K)
    assert v0.dtype == np.float32 and i0.dtype == np.int32


def test_query_blocks_pad_only_a_multi_block_search():
    q = _unit(300, 4)
    one = list(I.query_blocks(q, 512))
    assert len(one) == 1 and one[0][0].shape == (300, D) and one[0][1] == 300
    many = list(I.query_blocks(q, 128))
    assert [n for _, n in many] == [128, 128, 44]
    assert all(b.shape == (128, D) for b, _ in many)
    np.testing.assert_array_equal(many[-1][0][:44], q[256:])
    assert not many[-1][0][44:].any()
    assert list(I.query_blocks(q[:0], 128)) == []
