"""Port parity: FlatIndex and SQ8FlatIndex of nafp_tpu_torch against the
JAX package's classes on the same data (both on the CPU), the int8 store
format shared by both packages, and the factory's refusal of types that
later slices port."""
import numpy as np
import pytest
import torch

from nafp_tpu.search import index as J
from nafp_tpu_torch.search import index as P

CPU = torch.device("cpu")
# L2^2 / IP values in f32 from sums in other orders (XLA vs PyTorch).
RTOL, ATOL = 1e-5, 1e-5


def _unit(rng, n, d=128):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _near(rng, db, n):
    return (db[rng.integers(0, len(db), n)]
            + 0.05 * rng.standard_normal((n, db.shape[1])).astype(np.float32))


@pytest.mark.parametrize("metric,unit", [("l2", True), ("l2", False),
                                         ("ip", True)])
def test_flat_matches_jax(rng, metric, unit):
    db = _unit(rng, 3000)
    if not unit:    # unequal norms: l2 must not ride the IP route
        db *= (1.0 + rng.random(3000)[:, None]).astype(np.float32)
    q = _near(rng, db, 37)
    jv, ji = J.FlatIndex(db, metric=metric).search(q, k=10, block=16)
    idx = P.FlatIndex(db, metric=metric, device=CPU)
    assert idx._unit_norm == unit
    pv, pi = idx.search(q, k=10, block=16)
    assert pi.dtype == np.int32 and pv.shape == (37, 10)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_allclose(pv, jv, rtol=RTOL, atol=ATOL)


def test_flat_kernel_route_matches_jax_fused(rng, monkeypatch):
    """At >= PALLAS_MIN_ROWS (lowered here) the port routes through
    topk_ip (its plain version on the CPU) with host L2^2 recovery; the
    JAX package's fused route in interpret mode gives the same answer.
    Blocks of 512 with a padded last block (1100 queries)."""
    db = _unit(rng, 2500)
    q = _near(rng, db, 1100)
    jidx = J.FlatIndex(db, metric="l2")
    jidx.force_interpret_fused = True
    jv, ji = jidx.search(q, k=5)
    monkeypatch.setattr(P.FlatIndex, "PALLAS_MIN_ROWS", 1000)
    idx = P.FlatIndex(db, metric="l2", device=CPU)
    assert idx._use_kernel()
    pv, pi = idx.search(q, k=5)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_allclose(pv, jv, rtol=RTOL, atol=ATOL)


def test_flat_block_cap(rng):
    idx = P.FlatIndex.__new__(P.FlatIndex)
    idx.ntotal = 5_900_000
    cap = idx._xla_block_cap(2048)
    assert 1 <= cap < 2048 and cap * idx.ntotal * 4 <= idx.XLA_LOGITS_BUDGET


def test_quantize_sq8_host_byte_identical(rng):
    x = rng.standard_normal((2100, 64)).astype(np.float32)
    x[7] = 0.0                                    # all-zero row
    for a, b in zip(J._quantize_sq8_host(x, 2048, block=1000),
                    P._quantize_sq8_host(x, 2048, block=1000)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_sq8_matches_jax(rng):
    db = _unit(rng, 4196)
    q = _near(rng, db, 1500)          # two query blocks of 1024, padded
    jidx = J.SQ8FlatIndex()
    jidx.add(db)
    jv, ji = jidx.search(q, k=20)
    idx = P.get_index("sq8", db, device=CPU)
    idx.add(db)
    pv, pi = idx.search(q, k=20)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_allclose(pv, jv, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_sq8_store_loads_in_both_packages(rng, tmp_path, writer):
    db = _unit(rng, 2100)
    q = _near(rng, db, 9)
    path = str(tmp_path / "store.npz")
    if writer == "jax":
        J.SQ8FlatIndex().add(db, persist_path=path)
    else:
        P.SQ8FlatIndex(device=CPU).add(db, persist_path=path)
    with np.load(path) as z:
        assert sorted(z.files) == ["ids", "ntotal", "scales", "vecs8"]
    jv, ji = J.SQ8FlatIndex.load(path).search(q, k=7)
    pidx = P.SQ8FlatIndex.load(path, device=CPU)
    assert pidx.ntotal == 2100 and len(pidx.vecs8) % P.SQ8FlatIndex.BLK == 0
    pv, pi = pidx.search(q, k=7)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_allclose(pv, jv, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("t", ["ivfpq", "ivfpq-rr", "ivf-sq8", "hnsw",
                               "sq8-sharded", "l2-sharded"])
def test_later_slices_raise(rng, t):
    db = _unit(rng, 50)
    with pytest.raises(NotImplementedError, match="slice"):
        P.get_index(t, db, device=CPU)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        P.cacheable_cls(t)


def test_factory_and_cache_registry(rng):
    db = _unit(rng, 50)
    assert isinstance(P.get_index("ivf", db, device=CPU), P.FlatIndex)
    assert P.get_index("ip", db, device=CPU).metric == "ip"
    assert P.cacheable_cls("sq8-flat")[0] is P.SQ8FlatIndex
    assert P.cacheable_cls("l2") == (None, None)
    with pytest.raises(ValueError):
        P.get_index("bogus", db, device=CPU)


def test_index_on_cuda_without_card_raises(rng):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.FlatIndex(_unit(rng, 10))
