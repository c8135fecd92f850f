"""Port parity: IVFSQ8Index of nafp_tpu_torch against the JAX package's on
the CPU.

k-means cannot match draw for draw across the packages (jax.random vs a
torch.Generator), so the port's index gets the JAX index's centroids; from
there the store must be equal (vecs8, scales, starts, ids, list_cap) and a
search must return the same ids, with scores within 1e-2 relative (the JAX
package multiplies in bf16 with f32 accumulation; the port's products of
bf16 queries and int8 rows are exact in f32, summed in another order)."""
import numpy as np
import pytest
import torch

from nafp_tpu.search import index as J
from nafp_tpu_torch.search import index as P

CPU = torch.device("cpu")
SCORE_RTOL = 1e-2
STORE_KEYS = ("nlist", "list_cap", "ntotal", "centroids", "vecs8", "scales",
              "starts", "ids")


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _near(rng, db, n, noise=0.05):
    q = db[rng.integers(0, len(db), n)] + noise * rng.standard_normal(
        (n, db.shape[1])).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _port_with(jidx, nprobe=None):
    """A port index holding the JAX index's centroids."""
    p = P.IVFSQ8Index(d=jidx.d, nlist=jidx.nlist,
                      nprobe=nprobe or jidx.nprobe, device=CPU)
    p.centroids = torch.from_numpy(np.array(jidx.centroids))
    p._trained = True
    return p


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """A 3,000-row DB (nlist 256 by the automatic rule), both stores
    persisted."""
    rng = np.random.default_rng(7)
    db = _unit(rng, 3000, 32)
    d = tmp_path_factory.mktemp("ivfsq8")
    j = J.IVFSQ8Index(d=32, nprobe=8)
    j.train(db)
    j.add(db, persist_path=str(d / "jax.npz"))
    p = _port_with(j)
    p.add(db, persist_path=str(d / "port.npz"))
    return dict(db=db, j=j, p=p, jax_npz=str(d / "jax.npz"),
                port_npz=str(d / "port.npz"), dir=d)


def _assert_store_equal(a, b):
    with np.load(a) as za, np.load(b) as zb:
        assert sorted(za.files) == sorted(zb.files) == sorted(STORE_KEYS)
        for key in STORE_KEYS:
            np.testing.assert_array_equal(za[key], zb[key], err_msg=key)


def test_store_equals_jax(built):
    j, p = built["j"], built["p"]
    assert p.nlist == j.nlist == 256 and p.list_cap == j.list_cap
    _assert_store_equal(built["jax_npz"], built["port_npz"])
    np.testing.assert_array_equal(p.vecs8.numpy(), np.asarray(j.vecs8))
    np.testing.assert_array_equal(p.scales.numpy(), np.asarray(j.scales))
    np.testing.assert_array_equal(p.starts.numpy(), np.asarray(j.starts))
    np.testing.assert_array_equal(p.ids.numpy(), np.asarray(j.ids))
    # the tail: list_cap pad rows, id -1, zero rows
    n = len(built["db"])
    assert len(p.ids) == n + p.list_cap and (p.ids[n:] == -1).all()


def _check_search(j, p, q, k):
    jv, ji = j.search(q, k)
    pv, pi = p.search(q, k)
    np.testing.assert_array_equal(pi, ji)
    fin = np.isfinite(jv)
    np.testing.assert_array_equal(np.isfinite(pv), fin)
    np.testing.assert_allclose(pv[fin], jv[fin], rtol=SCORE_RTOL,
                               atol=SCORE_RTOL)
    return pv, pi


@pytest.mark.parametrize("nprobe,k", [(8, 10), (1, 4), (3, None)])
def test_search_matches_jax(built, nprobe, k):
    """Overlapping tail slices (every probe of a list shorter than
    list_cap scores rows of the next lists, so a row can be scored twice),
    and k = nprobe·list_cap, where duplicates and pad rows leave slots
    empty (id -1)."""
    rng = np.random.default_rng(nprobe)
    j, db = built["j"], built["db"]
    j.nprobe = nprobe
    p = _port_with(j)
    p.vecs8, p.scales, p.starts, p.ids = (built["p"].vecs8, built["p"].scales,
                                          built["p"].starts, built["p"].ids)
    p.list_cap, p.ntotal = built["p"].list_cap, built["p"].ntotal
    k = k or nprobe * p.list_cap
    # 150 queries: two full blocks of 64 and a padded one; the last list's
    # centroid among them, whose slice reads the pad rows
    q = _near(rng, db, 149)
    q = np.concatenate([q, np.asarray(j.centroids)[-1:]])
    _, pi = _check_search(j, p, q, k)
    if k == nprobe * p.list_cap:
        assert (pi == -1).any()


def test_k_above_rows_probed_raises(built):
    j, p = built["j"], built["p"]
    j.nprobe = p.nprobe = 1
    q = built["db"][:3]
    k = p.list_cap + 1
    with pytest.raises(ValueError):
        j.search(q, k)
    with pytest.raises(ValueError, match="exceeds"):
        p.search(q, k)
    j.nprobe = p.nprobe = 8


def test_streamed_memmap_add_equals_in_ram(built):
    db = built["db"]
    mm = np.memmap(str(built["dir"] / "db.mm"), dtype=np.float32, mode="w+",
                   shape=db.shape)
    mm[:] = db
    mm.flush()
    p = _port_with(built["j"])
    p.add(np.memmap(str(built["dir"] / "db.mm"), dtype=np.float32, mode="r",
                    shape=db.shape), block=700,
          persist_path=str(built["dir"] / "streamed.npz"))
    _assert_store_equal(built["port_npz"], str(built["dir"] / "streamed.npz"))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_store_loads_in_both_packages(built, writer):
    path = built["jax_npz"] if writer == "jax" else built["port_npz"]
    q = _near(np.random.default_rng(3), built["db"], 40)
    j = J.IVFSQ8Index.load(path, nprobe=8)
    p = P.IVFSQ8Index.load(path, nprobe=8, device=CPU)
    assert (p.nlist, p.list_cap, p.ntotal) == (j.nlist, j.list_cap,
                                               j.ntotal)
    _check_search(j, p, q, 10)


def test_factory_builds_ivfsq8(built):
    db = built["db"]
    idx = P.get_index("ivf-sq8", db, nprobe=5, device=CPU)
    assert isinstance(idx, P.IVFSQ8Index) and idx.nprobe == 5
    assert idx.nlist == 256 and tuple(idx.centroids.shape) == (256, 32)
    idx.add(db)
    q = _near(np.random.default_rng(4), db, 30, noise=0.01)
    _, ids = idx.search(q, 5)
    want = np.argmax(q @ db.T, axis=1)
    assert (ids[:, 0] == want).mean() >= 0.9


def _write_emb(root, rng, d=32):
    from nafp_tpu_torch.data.audio_io import create_memmap
    dummy = _unit(rng, 3000, d)
    db = _unit(rng, 700, d)
    query = db + 0.08 * rng.standard_normal(db.shape).astype(np.float32)
    query /= np.linalg.norm(query, axis=1, keepdims=True)
    for key, a in (("dummy_db", dummy), ("db", db), ("query", query)):
        mm = create_memmap(root, key, a.shape)
        mm[:] = a
        mm.flush()
    return np.concatenate([dummy, db])


def test_evaluate_raw_score_matches_jax(tmp_path, monkeypatch):
    """``evaluate -i ivf-sq8`` of both packages over the same memmaps: the
    port's index trained with the centroids the JAX evaluate's k-means
    draws, raw_score.npy equal."""
    from nafp_tpu.search.evaluate import eval_fingerprints as jax_eval
    from nafp_tpu_torch.search.evaluate import eval_fingerprints
    emb = str(tmp_path)
    full = _write_emb(emb, np.random.default_rng(11))
    ref = J.IVFSQ8Index(d=32, nprobe=40)
    ref.train(full)                      # what the JAX evaluate trains
    kw = dict(index_type="ivf-sq8", test_ids="120",
              test_seq_len="1 3 5", nprobe=40)
    jax_eval(emb, **kw)
    want = np.load(f"{emb}/raw_score.npy")

    def train(self, data, max_train=None, kmeans_iters=10, seed=0):
        assert len(data) == len(full) and max_train is None
        self.nlist = ref.nlist
        self.centroids = torch.from_numpy(np.array(ref.centroids))
        self._trained = True
    monkeypatch.setattr(P.IVFSQ8Index, "train", train)
    eval_fingerprints(emb, device=CPU, **kw)
    got = np.load(f"{emb}/raw_score.npy")
    assert got.shape == want.shape == (120, 12)
    np.testing.assert_array_equal(got, want)
    assert want[:, 0].mean() > 0.5      # the protocol finds the songs
