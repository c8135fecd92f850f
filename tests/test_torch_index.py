"""Port parity: FlatIndex, SQ8FlatIndex, k-means and IVFPQIndex of
nafp_tpu_torch against the JAX package's on the same data (both on the
CPU), the int8 and IVF-PQ store formats shared by both packages, and the
factory's refusal of types still to port.

IVF-PQ training cannot match across the packages (jax.random draws vs a
torch.Generator's), so the add/search tests install the same seeded numpy
centroids and codebooks in both indexes."""
import jax.numpy as jnp
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


@pytest.mark.parametrize("t", ["ivf-sq8", "hnsw", "sq8-sharded",
                               "l2-sharded"])
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


# ---------------------------------------------------------------------------
# k-means
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,k,d", [(2000, 16, 32), (3000, 256, 2)])
def test_lloyd_step_matches_jax(rng, n, k, d):
    """One Lloyd step from identical centroids (one far away, so its
    cluster is empty and must keep its centroid): centroids within rtol
    1e-5 (one-hot sums in another order), assignments identical."""
    x = rng.standard_normal((n, d)).astype(np.float32)
    c0 = x[rng.choice(n, k, replace=False)].copy()
    c0[0] = 100.0
    want = np.asarray(J._lloyd_step(jnp.asarray(x), jnp.asarray(c0)))
    got = P._lloyd_step(torch.from_numpy(x), torch.from_numpy(c0)).numpy()
    np.testing.assert_array_equal(got[0], c0[0])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(
        P.assign_to_centroids(x, torch.from_numpy(c0), block=512),
        J.assign_to_centroids(x, jnp.asarray(c0), block=512))


def _clusters(rng, n_per=200, centers=8, d=16, spread=0.05):
    ctr = rng.standard_normal((centers, d)).astype(np.float32) * 5
    x = np.concatenate([c + spread * rng.standard_normal((n_per, d))
                        for c in ctr]).astype(np.float32)
    return ctr, x


def test_kmeans_separates_clusters(rng):
    ctr, x = _clusters(rng)
    cents = P.kmeans(torch.from_numpy(x), 8, iters=10).numpy()
    dist = np.linalg.norm(cents[:, None] - ctr[None], axis=-1)
    assert (dist.min(axis=0) < 0.2).all()


def test_kmeanspp_seeds_are_distinct_rows_from_each_cluster(rng):
    """k-means++ by its properties (its draws are not jax.random's): every
    seed is a data row, well-separated clusters each get one, and a seed
    fixes the draws."""
    ctr, x = _clusters(rng)
    xt = torch.from_numpy(x)

    def seeds(s):
        return P._kmeanspp_init(xt, 8, torch.Generator().manual_seed(s))
    c = seeds(3).numpy()
    assert all((x == row).all(axis=1).any() for row in c)
    nearest = np.linalg.norm(c[:, None] - ctr[None], axis=-1).argmin(1)
    assert sorted(nearest) == list(range(8))
    torch.testing.assert_close(seeds(3), seeds(3), rtol=0, atol=0)
    assert not torch.equal(seeds(3), seeds(4))


# ---------------------------------------------------------------------------
# IVF-PQ
# ---------------------------------------------------------------------------
D, NLIST, M = 32, 16, 16


def _books(rng, db, nlist=NLIST, m=M):
    """Seeded centroids (noisy DB rows) and PQ codebooks (m, 256, d/m)."""
    cents = db[rng.choice(len(db), nlist, replace=False)] \
        + 0.01 * rng.standard_normal((nlist, db.shape[1])).astype(np.float32)
    books = 0.05 * rng.standard_normal((m, 256, db.shape[1] // m))
    return cents.astype(np.float32), books.astype(np.float32)


def _install(idx, cents, books):
    """What train() leaves behind, from given arrays, in either package."""
    if isinstance(idx, P.IVFPQIndex):
        idx.centroids = torch.from_numpy(cents).to(idx.device)
        idx.codebooks = torch.from_numpy(books).to(idx.device)
    else:
        idx.centroids, idx.codebooks = jnp.asarray(cents), jnp.asarray(books)
        idx._books_q_cache = None
    idx._trained = True
    return idx


def _pair(db, cents, books, **kw):
    """A JAX and a port IVF-PQ index with the same books (not yet added)."""
    j = _install(J.IVFPQIndex(d=db.shape[1], nlist=len(cents),
                              m=len(books), **kw), cents, books)
    p = _install(P.IVFPQIndex(d=db.shape[1], nlist=len(cents), m=len(books),
                              device=CPU, **kw), cents, books)
    return j, p


@pytest.mark.parametrize("steps", ["default", "small"])
@pytest.mark.parametrize("source", ["array", "memmap"])
def test_ivfpq_add_matches_jax(rng, tmp_path, monkeypatch, steps, source):
    """Same books -> identical codes, ids, sub_list and n_pad, with the
    port's default encode/assignment steps and with small ones (codes do
    not depend on the step), from an array and streamed off a memmap."""
    db = _unit(rng, 3000, D)
    cents, books = _books(rng, db)
    if steps == "small":
        monkeypatch.setattr(P.IVFPQIndex, "ENCODE_ROWS", 256)
        monkeypatch.setattr(P.IVFPQIndex, "ASSIGN_ROWS", 300)
    src = db
    if source == "memmap":
        path = str(tmp_path / "db.mm")
        mm = np.memmap(path, np.float32, "w+", shape=db.shape)
        mm[:] = db
        mm.flush()
        src = np.memmap(path, np.float32, "r", shape=db.shape)
    j, p = _pair(db, cents, books, nprobe=4)
    j.add(src, block=700)
    p.add(src, block=700)
    assert p.n_pad == j.n_pad and p.n_pad % P.IVFPQIndex.BLK == 0
    assert p.ntotal == 3000
    np.testing.assert_array_equal(p.codes.numpy(), np.asarray(j.codes))
    np.testing.assert_array_equal(p.ids.numpy(), np.asarray(j.ids))
    np.testing.assert_array_equal(p.sub_list.numpy(), np.asarray(j.sub_list))


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_ivfpq_store_loads_in_both_packages(rng, tmp_path, writer):
    db = _unit(rng, 3000, D)
    cents, books = _books(rng, db)
    q = _near(rng, db, 12)
    path = str(tmp_path / "pq.npz")
    j, p = _pair(db, cents, books, nprobe=4)
    (j if writer == "jax" else p).add(db, persist_path=path)
    with np.load(path) as z:
        assert sorted(z.files) == sorted(["nlist", "m", "ksub", "ntotal",
                                          "centroids", "codebooks", "codes",
                                          "ids", "sub_list"])
    jl = J.IVFPQIndex.load(path, nprobe=4)
    pl = P.IVFPQIndex.load(path, nprobe=4, device=CPU)
    assert (pl.ntotal, pl.n_pad, pl.ksub) == (3000, jl.n_pad, 256)
    jv, ji = jl.search(q, k=7)
    pv, pi = pl.search(q, k=7)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_allclose(pv, jv, rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def pq_pair():
    """One IVF-PQ store in both packages (same books), 9,000 rows: enough
    for 3+ chunks of 2 * BLK."""
    rng = np.random.default_rng(5)
    db = _unit(rng, 9000, D)
    cents, books = _books(rng, db)
    q = _near(rng, db, 48)
    return db, cents, books, q


@pytest.mark.parametrize("refine", [False, True], ids=["ivfpq", "ivfpq-rr"])
@pytest.mark.parametrize("mode", ["single", "blocks", "chunks"])
def test_ivfpq_search_matches_jax(pq_pair, refine, mode):
    """Search against the JAX package: identical ids, scores within RTOL
    where the id is >= 0; a multi-block search (block 16), a multi-chunk
    search (chunk_rows 2 * BLK) and a single call all agree."""
    db, cents, books, q = pq_pair
    j, p = _pair(db, cents, books, nprobe=4, refine=refine)
    j.add(db)
    p.add(db)
    kw = {"single": {}, "blocks": {"block": 16},
          "chunks": {"block": 16, "chunk_rows": 2 * P.IVFPQIndex.BLK}}[mode]
    jv, ji = j.search(q, 10, **kw)
    pv, pi = p.search(q, 10, **kw)
    assert pi.dtype == np.int32 and pv.shape == (48, 10)
    np.testing.assert_array_equal(pi, ji)
    ok = pi >= 0
    np.testing.assert_allclose(pv[ok], jv[ok], rtol=RTOL, atol=ATOL)
    sv, si = p.search(q, 10)
    np.testing.assert_array_equal(pi, si)
    np.testing.assert_allclose(pv, sv, rtol=RTOL, atol=ATOL)


def test_ivfpq_probe_pruned_scan_matches_linear(rng, monkeypatch):
    """Three queries probing 4 of 32 lists take the pruned route (a spy
    sees _pq_gather_subtiles) and return exactly the linear scan's ids;
    a saturated probe union (nprobe == nlist) stays linear."""
    db = _unit(rng, 6000, 16)
    cents, books = _books(rng, db, nlist=32, m=8)
    q = db[[5, 77, 2345]] + 0.01 * rng.standard_normal((3, 16)).astype(
        np.float32)
    idx = _install(P.IVFPQIndex(d=16, nlist=32, m=8, nprobe=4, device=CPU),
                   cents, books)
    idx.add(db)
    calls = []
    orig = P._pq_gather_subtiles

    def spy(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)
    monkeypatch.setattr(P, "_pq_gather_subtiles", spy)
    idx.PRUNE_COVERAGE = -1.0                   # no coverage qualifies
    d0, i0 = idx.search(q, k=5)
    assert not calls
    del idx.PRUNE_COVERAGE                      # the class's share again
    d1, i1 = idx.search(q, k=5)
    assert calls, "pruned route did not engage at 3 queries / 4 probes"
    np.testing.assert_array_equal(i1, i0)
    np.testing.assert_allclose(d1, d0, atol=1e-6)
    calls.clear()
    idx.nprobe = 32
    idx.search(q, k=5)
    assert not calls


def test_ivfpq_decode_matches_jax(rng):
    """The gather decode selects the codewords in f32 and adds the list's
    centroid: on the CPU that equals the JAX package's one-hot decode bit
    for bit (filler subtiles included), before and after the bf16 cast."""
    db = _unit(rng, 3000, D)
    cents, books = _books(rng, db)
    j, p = _pair(db, cents, books)
    j.add(db)
    p.add(db)
    got = P._pq_decode_chunk(p.codes, p.sub_list, p.codebooks, p.centroids,
                             lt=p.LIST_TILE)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (p.n_pad, D)
    want = J._pq_decode_chunk(j.codes, j.sub_list, j.codebooks, j.centroids,
                              lt=j.LIST_TILE)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def test_ivfpq_train_assignment_steps_do_not_matter(rng, monkeypatch):
    """train() assigns the resident training rows to lists in ASSIGN_ROWS
    steps: small steps give the same centroids and codebooks (k-means on
    the CPU is deterministic given the seed)."""
    db = _unit(rng, 1200, 16)

    def trained():
        idx = P.IVFPQIndex(d=16, nlist=8, m=4, nprobe=2, device=CPU)
        idx.train(db, kmeans_iters=3, seed=7)
        return idx
    ref = trained()
    monkeypatch.setattr(P.IVFPQIndex, "ASSIGN_ROWS", 100)
    small = trained()
    torch.testing.assert_close(small.centroids, ref.centroids, rtol=0, atol=0)
    torch.testing.assert_close(small.codebooks, ref.codebooks, rtol=0, atol=0)


def test_get_index_ivfpq_trains_and_searches(rng):
    """The factory's IVF-PQ trains the port's own k-means (nlist 256,
    m = d/2 at d 32) and finds near-duplicate queries; re-ranking does not
    lose recall (the rule of tests/test_index.py's IVF-PQ recall test)."""
    db = _unit(rng, 2000, D)
    q = db[:40] + 0.02 * rng.standard_normal((40, D)).astype(np.float32)
    top1 = {}
    for t in ("ivfpq", "ivfpq-rr"):
        idx = P.get_index(t, db, nprobe=40, device=CPU)
        assert isinstance(idx, P.IVFPQIndex) and idx.refine == (t != "ivfpq")
        assert (idx.nlist, idx.m, idx.nprobe) == (256, 16, 40)
        assert tuple(idx.codebooks.shape) == (16, 256, 2)
        idx.add(db)
        _, ids = idx.search(q, 5)
        top1[t] = float((ids[:, 0] == np.arange(40)).mean())
        assert P.cacheable_cls(t) == (None, None)
    assert top1["ivfpq"] >= 0.8
    assert top1["ivfpq-rr"] >= top1["ivfpq"] - 0.02


def test_ivfpq_train_needs_four_rows_per_list(rng):
    idx = P.IVFPQIndex(d=D, nlist=16, m=M, device=CPU)
    with pytest.raises(ValueError, match="training vectors"):
        idx.train(_unit(rng, 63, D))
    with pytest.raises(ValueError, match="multiple of m"):
        P.IVFPQIndex(d=30, m=16, device=CPU)
