"""Port parity: the sharded indexes of nafp_tpu_torch (search/sharded.py).

The nine tests of ``tests/test_sharded_search.py``, on 8 CPU shards (one
device repeated; its query-block test is the ``l2-sharded`` case of
``tests/test_torch_query_blocks.py``), then the port against the JAX package's sharded indexes
on the 8-device CPU mesh of ``tests/conftest.py`` with the same seed-made
inputs (JAX's kernel B2 in interpret mode, as its sharded index runs it
off the TPU):

- ``l2-sharded``: ids equal, scores within 1e-5 (f32 products summed in
  other orders);
- ``sq8-sharded``: ids equal, scores within 1e-6;
- ``ivf-sq8-sharded``, the JAX index's centroids given to the port: ids
  equal, scores within 1e-2 relative (the JAX package multiplies in bf16,
  see tests/test_torch_ivfsq8.py);
- the ``.npz`` stores cross both ways: JAX <-> port, and sharded <->
  single-device, at another shard count too;
- ``evaluate -i l2-sharded / sq8-sharded / ivf-sq8-sharded --nogpu`` (one
  CPU shard) give the raw_score.npy of ``-i l2 / sq8 / ivf-sq8``.
"""
import os

import numpy as np
import pytest
import torch
import yaml
from click.testing import CliRunner

from nafp_tpu_torch.search.index import FlatIndex, IVFSQ8Index, SQ8FlatIndex
from nafp_tpu_torch.search.sharded import (ShardedFlatIndex,
                                           ShardedIVFSQ8Index,
                                           ShardedSQ8FlatIndex)

CPU = torch.device("cpu")
SHARDS = [CPU] * 8          # the conftest mesh's size
F32_ATOL = 1e-5
SQ8_RTOL = 1e-6
IVF_SCORE_RTOL = 1e-2


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _near(rng, db, n, noise):
    return db[rng.integers(0, len(db), n)] + noise * rng.standard_normal(
        (n, db.shape[1])).astype(np.float32)


# ---------------------------------------------------------------------------
# The JAX package's nine tests, on 8 CPU shards
# ---------------------------------------------------------------------------
def test_sharded_equals_flat(rng):
    db = _unit(rng, 4001, 64)                        # not a multiple of 8
    q = _near(rng, db, 33, 0.01)
    fv, fi = FlatIndex(db, metric="ip", device=CPU).search(q, k=7)
    sharded = ShardedFlatIndex(db, devices=SHARDS)
    assert len(sharded.shards) == 8
    sv, si = sharded.search(q, k=7)
    np.testing.assert_allclose(sv, fv, atol=F32_ATOL)
    np.testing.assert_array_equal(si, fi)
    assert (si >= 0).all() and (si < 4001).all()     # no pad leakage


def test_sharded_ivfsq8_matches_single_device(rng):
    """nprobe == nlist: both layouts scan every row, so the sharded index
    reproduces the single-device one (same centroids: the same seed on
    the same device)."""
    db = _unit(rng, 6001, 64)
    q = _near(rng, db, 40, 0.02)
    single = IVFSQ8Index(d=64, nlist=16, nprobe=16, device=CPU)
    single.train(db)
    single.add(db)
    dv, di = single.search(q, k=10)
    sharded = ShardedIVFSQ8Index(d=64, nlist=16, nprobe=16, devices=SHARDS)
    sharded.train(db)
    sharded.add(db)
    assert len(sharded.shards) == 8
    sv, si = sharded.search(q, k=10)
    np.testing.assert_allclose(np.sort(sv, axis=1), np.sort(dv, axis=1),
                               rtol=1e-5, atol=1e-6)
    for r in range(len(q)):          # ids differ only at a score tie
        if set(di[r]) ^ set(si[r]):
            assert np.isclose(dv[r].min(), sv[r].min(), atol=1e-6)
    assert (si[:, 0] == di[:, 0]).all()


def test_sharded_ivfsq8_partial_probe_recall(rng):
    """nprobe << nlist: the sharded index's recall against exact search
    matches the single-device index's (same probed lists, same rows)."""
    db = _unit(rng, 8000, 32)
    q = _near(rng, db, 64, 0.02)
    _, gt = FlatIndex(db, metric="ip", device=CPU).search(q, k=5)

    def recall(idx):
        idx.train(db)
        idx.add(db)
        _, ids = idx.search(q, k=5)
        return np.mean([len(set(a) & set(b)) / 5.0 for a, b in zip(ids, gt)])

    r_single = recall(IVFSQ8Index(d=32, nlist=32, nprobe=8, device=CPU))
    r_sharded = recall(ShardedIVFSQ8Index(d=32, nlist=32, nprobe=8,
                                          devices=SHARDS))
    assert r_sharded >= r_single - 0.02
    assert r_sharded > 0.5


def test_sharded_sq8flat_matches_single_device(rng):
    """Disjoint row ranges and a global top-k: ids and scores equal the
    single-device scan's (same quantization per row)."""
    db = _unit(rng, 5003, 128)
    q = _near(rng, db, 16, 0.02)
    single = SQ8FlatIndex(device=CPU)
    single.add(db)
    sv, si = single.search(q, k=5)
    sharded = ShardedSQ8FlatIndex(devices=SHARDS)
    sharded.add(db)
    assert len(sharded.shards) == 8
    rows = {len(s.vecs8) for s in sharded.shards}
    assert len(rows) == 1 and rows.pop() % ShardedSQ8FlatIndex.BLK == 0
    mv, mi = sharded.search(q, k=5)
    np.testing.assert_array_equal(mi, si)
    np.testing.assert_allclose(mv, sv, rtol=SQ8_RTOL)
    assert (mi >= 0).all() and (mi < 5003).all()


def test_sharded_sq8flat_persist_load_roundtrip(rng, tmp_path):
    """A store the sharded add persisted loads onto the shards and into the
    single-device index (one format) with the same results."""
    db = _unit(rng, 4100, 128)
    q = _near(rng, db, 12, 0.02)
    path = str(tmp_path / "sq8_store.npz")
    built = ShardedSQ8FlatIndex(devices=SHARDS)
    built.add(db, persist_path=path)
    bv, bi = built.search(q, k=5)
    loaded = ShardedSQ8FlatIndex.load(path, devices=SHARDS)
    lv, li = loaded.search(q, k=5)
    assert loaded.ntotal == built.ntotal
    np.testing.assert_array_equal(li, bi)
    np.testing.assert_allclose(lv, bv, rtol=SQ8_RTOL)
    _, si = SQ8FlatIndex.load(path, device=CPU).search(q, k=5)
    np.testing.assert_array_equal(si, bi)


def test_sharded_sq8flat_loads_single_device_store(rng, tmp_path):
    """The reverse: a SQ8FlatIndex store loads onto 8 shards (repadded to
    8 x BLK) and onto 3."""
    db = _unit(rng, 3000, 128)
    q = _near(rng, db, 8, 0.02)
    path = str(tmp_path / "sq8_single.npz")
    single = SQ8FlatIndex(device=CPU)
    single.add(db, persist_path=path)
    _, si = single.search(q, k=5)
    for shards in (SHARDS, [CPU] * 3):
        sharded = ShardedSQ8FlatIndex.load(path, devices=shards)
        _, mi = sharded.search(q, k=5)
        assert sharded.ntotal == 3000
        np.testing.assert_array_equal(mi, si)


def test_sharded_ivfsq8_persist_load_roundtrip(rng, tmp_path):
    """The sharded IVF-SQ8 persists the single-device format; loading
    rebuilds the round-robin layout (same ids and scores), and the
    single-device index loads the same file."""
    db = _unit(rng, 6001, 64)
    q = _near(rng, db, 24, 0.02)
    path = str(tmp_path / "ivfsq8_store.npz")
    built = ShardedIVFSQ8Index(d=64, nlist=16, nprobe=16, devices=SHARDS)
    built.train(db)
    built.add(db, persist_path=path)
    bv, bi = built.search(q, k=10)
    loaded = ShardedIVFSQ8Index.load(path, nprobe=16, devices=SHARDS)
    lv, li = loaded.search(q, k=10)
    assert loaded.ntotal == built.ntotal
    assert loaded.list_cap == built.list_cap
    np.testing.assert_array_equal(li, bi)
    np.testing.assert_allclose(lv, bv, rtol=1e-6)
    _, di = IVFSQ8Index.load(path, nprobe=16, device=CPU).search(q, k=10)
    assert (di[:, 0] == bi[:, 0]).all()


def test_sharded_ivfsq8_loads_single_device_store(rng, tmp_path):
    """A single-device IVFSQ8Index store loads onto the shards: the dealt
    layout scans the same rows per probe. At one shard the results are the
    single-device index's, bit for bit."""
    db = _unit(rng, 5000, 64)
    q = _near(rng, db, 24, 0.02)
    path = str(tmp_path / "ivfsq8_single.npz")
    single = IVFSQ8Index(d=64, nlist=16, nprobe=16, device=CPU)
    single.train(db)
    single.add(db, persist_path=path)
    dv, di = single.search(q, k=10)
    sharded = ShardedIVFSQ8Index.load(path, nprobe=16, devices=SHARDS)
    sv, si = sharded.search(q, k=10)
    assert sharded.ntotal == 5000
    assert (si[:, 0] == di[:, 0]).all()
    np.testing.assert_allclose(np.sort(sv, axis=1), np.sort(dv, axis=1),
                               rtol=1e-5, atol=1e-6)
    ov, oi = ShardedIVFSQ8Index.load(path, nprobe=16,
                                     devices=[CPU]).search(q, k=10)
    np.testing.assert_array_equal(oi, di)
    np.testing.assert_array_equal(ov, dv)


# ---------------------------------------------------------------------------
# Against the JAX package's sharded indexes on the 8-device CPU mesh
# ---------------------------------------------------------------------------
def test_flat_matches_jax_sharded(rng):
    from nafp_tpu.search.sharded import ShardedFlatIndex as JFlat
    db = _unit(rng, 4001, 64)
    q = _near(rng, db, 40, 0.01)
    jv, ji = JFlat(db).search(q, k=9)
    pv, pi = ShardedFlatIndex(db, devices=SHARDS).search(q, k=9)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_allclose(pv, jv, atol=F32_ATOL)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_sq8_matches_jax_sharded_and_stores_cross(rng, tmp_path, writer):
    """Both packages' sharded sq8 scans give the same ids and scores, and a
    store either one persisted loads in the other (sharded and single)."""
    from nafp_tpu.search.index import SQ8FlatIndex as JSingle
    from nafp_tpu.search.sharded import ShardedSQ8FlatIndex as JSharded
    db = _unit(rng, 5003, 128)
    q = _near(rng, db, 16, 0.02)
    path = str(tmp_path / "sq8.npz")
    if writer == "jax":
        JSharded().add(db, persist_path=path)
    else:
        ShardedSQ8FlatIndex(devices=SHARDS).add(db, persist_path=path)
    jv, ji = JSharded.load(path).search(q, k=7)
    pv, pi = ShardedSQ8FlatIndex.load(path, devices=SHARDS).search(q, k=7)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_allclose(pv, jv, rtol=SQ8_RTOL, atol=SQ8_RTOL)
    np.testing.assert_array_equal(JSingle.load(path).search(q, k=7)[1], ji)
    np.testing.assert_array_equal(
        SQ8FlatIndex.load(path, device=CPU).search(q, k=7)[1], pi)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_ivfsq8_matches_jax_sharded_and_stores_cross(rng, tmp_path, writer):
    """The JAX index's centroids in the port: the same ids, the store of
    either package loads in the other's sharded and single-device index,
    and the two stores are equal."""
    import jax.numpy as jnp
    from nafp_tpu.search.index import IVFSQ8Index as JSingle
    from nafp_tpu.search.sharded import ShardedIVFSQ8Index as JSharded
    db = _unit(rng, 6001, 64)
    q = _near(rng, db, 32, 0.02)
    j = JSharded(d=64, nlist=16, nprobe=6)
    j.train(db)
    p = ShardedIVFSQ8Index(d=64, nlist=16, nprobe=6, devices=SHARDS)
    p.centroids = torch.from_numpy(np.array(j.centroids))
    p._trained = True
    jpath, ppath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    j.add(db, persist_path=jpath)
    p.add(db, persist_path=ppath)
    with np.load(jpath) as a, np.load(ppath) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert p.list_cap == j.list_cap
    jv, ji = j.search(q, k=10)
    pv, pi = p.search(q, k=10)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_allclose(pv, jv, rtol=IVF_SCORE_RTOL, atol=1e-6)
    path = jpath if writer == "jax" else ppath
    lv, li = ShardedIVFSQ8Index.load(path, nprobe=6, devices=SHARDS).search(
        q, k=10)
    np.testing.assert_array_equal(li, pi)
    _, jli = JSharded.load(path, nprobe=6).search(q, k=10)
    np.testing.assert_array_equal(jli, ji)
    _, si = JSingle.load(path, nprobe=6).search(q, k=10)
    _, psi = IVFSQ8Index.load(path, nprobe=6, device=CPU).search(q, k=10)
    np.testing.assert_array_equal(psi[:, 0], si[:, 0])
    assert jnp.asarray(j.centroids).shape == (16, 64)


# ---------------------------------------------------------------------------
# Through the CLI
# ---------------------------------------------------------------------------
def test_cli_sharded_types_equal_their_single_device_twins(rng, tmp_path):
    """``evaluate --nogpu`` with each sharded type (one CPU shard) writes
    the raw_score.npy of its single-device twin; ivf-sq8-sharded loads the
    store ivf-sq8 persisted (the same centroids), sq8-sharded the sq8
    one."""
    from nafp_tpu_torch.cli import main
    from nafp_tpu_torch.configuration import load_config
    from nafp_tpu_torch.data.audio_io import create_memmap
    emb = tmp_path / "emb" / "run" / "1"
    db = _unit(rng, 600, 16)
    query = db + 0.05 * rng.standard_normal(db.shape).astype(np.float32)
    for key, arr in (("db", db), ("query", query),
                     ("dummy_db", _unit(rng, 900, 16))):
        m = create_memmap(str(emb), key, arr.shape)
        m[:] = arr
        m.flush()
    cfg = load_config("default")
    cfg["DIR"]["OUTPUT_ROOT_DIR"] = str(tmp_path / "emb")
    cfg_path = str(tmp_path / "cfg.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    raw = {}
    for t in ("l2", "l2-sharded", "sq8", "sq8-sharded", "ivf-sq8",
              "ivf-sq8-sharded"):
        single = t.replace("-sharded", "")
        args = ["evaluate", "run", "1", "-c", cfg_path, "-i", t, "-t", "40",
                "--test_seq_len", "1 3", "--nprobe", "8", "--nogpu"]
        if single != "l2":
            args += ["--index_cache", str(tmp_path / f"{single}.npz")]
        res = CliRunner().invoke(main, args)
        assert res.exit_code == 0, res.output + repr(res.exception)
        if t.endswith("sharded") and single != "l2":
            assert "loaded persisted" in res.output
        raw[t] = np.load(emb / "raw_score.npy")
    for t in ("l2", "sq8", "ivf-sq8"):
        np.testing.assert_array_equal(raw[t + "-sharded"], raw[t], err_msg=t)
    assert raw["l2"][:, 0].mean() > 0.5
    assert os.path.exists(tmp_path / "ivf-sq8.npz")
