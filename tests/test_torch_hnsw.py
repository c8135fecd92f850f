"""The port's native HNSW index (``nafp_tpu_torch/native/hnsw.py`` over its
own copy of ``hnsw.cc``): the cases of ``tests/test_hnsw.py``, the factory
and ``evaluate --ef_search``."""
import os
import subprocess

import numpy as np
import pytest
import torch
import yaml
from click.testing import CliRunner

from nafp_tpu_torch.native import hnsw as H
from nafp_tpu_torch.native.hnsw import HNSWIndex
from nafp_tpu_torch.search import index as P


def _unit(rng, n, d=64):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def test_hnsw_builds_and_searches(rng):
    db = _unit(rng, 3000)
    idx = HNSWIndex(d=64, m=16, ef_construction=80)
    idx.add(db)
    assert idx.ntotal == 3000
    q = db[[5, 77, 2999]] + 0.01 * rng.standard_normal((3, 64)).astype(
        np.float32)
    scores, ids = idx.search(q, k=5, ef_search=64)
    assert ids.shape == (3, 5)
    np.testing.assert_array_equal(ids[:, 0], [5, 77, 2999])
    assert (np.diff(scores, axis=1) <= 1e-5).all()   # descending IP


def test_hnsw_recall_vs_exact(rng):
    db = _unit(rng, 8000)
    idx = HNSWIndex(d=64, m=16, ef_construction=80)
    idx.add(db)
    q = db[rng.integers(0, 8000, 100)] + \
        0.03 * rng.standard_normal((100, 64)).astype(np.float32)
    gt = np.argmax(q @ db.T, axis=1)
    _, ids = idx.search(q, k=10, ef_search=128)
    recall = np.mean([gt[i] in ids[i] for i in range(100)])
    assert recall >= 0.95, f"HNSW top-10 recall {recall}"


def test_hnsw_incremental_add(rng):
    a, b = _unit(rng, 500), _unit(rng, 500)
    idx = HNSWIndex(d=64)
    idx.add(a)
    idx.add(b)
    assert idx.ntotal == 1000
    _, ids = idx.search(b[:3], k=1, ef_search=64)
    np.testing.assert_array_equal(ids[:, 0], [500, 501, 502])


def test_hnsw_k_exceeds_n(rng):
    db = _unit(rng, 5)
    idx = HNSWIndex(d=64)
    idx.add(db)
    scores, ids = idx.search(db[:1], k=8)
    assert (ids[0, 5:] == -1).all()


def test_hnsw_save_load_roundtrip(rng, tmp_path):
    """save() + load() reproduce the graph: identical ids and scores."""
    db = _unit(rng, 4000)
    idx = HNSWIndex(d=64, m=16, ef_construction=80)
    idx.add(db)
    q = db[rng.integers(0, 4000, 50)] + \
        0.02 * rng.standard_normal((50, 64)).astype(np.float32)
    sv, si = idx.search(q, k=10, ef_search=96)
    path = str(tmp_path / "graph.hnsw")
    idx.save(path)
    loaded = HNSWIndex.load(path, ef_search=96)
    assert loaded.ntotal == 4000 and loaded.d == 64
    lv, li = loaded.search(q, k=10, ef_search=96)
    np.testing.assert_array_equal(li, si)
    np.testing.assert_allclose(lv, sv)
    loaded.add(_unit(rng, 100))        # a loaded index stays mutable
    assert loaded.ntotal == 4100


def test_hnsw_load_missing_raises(tmp_path):
    with pytest.raises(IOError):
        HNSWIndex.load(str(tmp_path / "nope.hnsw"))


def test_hnsw_load_rejects_oversized_n(rng, tmp_path):
    """A header n larger than the file can hold fails with IOError, not a
    multi-GB resize (header: magic 8 + version 4 + hdr 20 + seed 8, then n
    as int64 at byte 40)."""
    db = _unit(rng, 200)
    idx = HNSWIndex(d=64, m=16, ef_construction=40)
    idx.add(db)
    path = str(tmp_path / "graph.hnsw")
    idx.save(path)
    blob = bytearray(open(path, "rb").read())
    blob[40:48] = (1 << 60).to_bytes(8, "little")
    open(path, "wb").write(bytes(blob))
    with pytest.raises(IOError):
        HNSWIndex.load(path)


def test_hnsw_parallel_add_matches_serial_recall(rng):
    db = _unit(rng, 6000)
    q = db[rng.integers(0, 6000, 100)] + \
        0.03 * rng.standard_normal((100, 64)).astype(np.float32)
    gt = np.argmax(q @ db.T, axis=1)

    def recall(threads):
        idx = HNSWIndex(d=64, m=16, ef_construction=80)
        idx.add(db, threads=threads)
        assert idx.ntotal == 6000
        _, ids = idx.search(q, k=10, ef_search=128)
        return np.mean([gt[i] in ids[i] for i in range(100)])

    r_serial = recall(1)
    r_par = recall(4)
    assert r_par >= r_serial - 0.03, (r_par, r_serial)
    assert r_par >= 0.9


def test_hnsw_tsan_harness(tmp_path):
    """The port's copy built as the standalone TSan binary (threaded add +
    searches): a data race in the lock-striped insert aborts it. Skipped
    only when g++ has no TSan runtime."""
    probe = str(tmp_path / "probe")
    with open(probe + ".cc", "w") as f:
        f.write("int main(){return 0;}\n")
    try:
        subprocess.run(["g++", "-fsanitize=thread", probe + ".cc", "-o",
                        probe], check=True, capture_output=True, timeout=60)
    except subprocess.CalledProcessError as e:
        pytest.skip(f"no TSan toolchain: {e.stderr[-200:]}")
    exe = str(tmp_path / "hnsw_tsan")
    subprocess.run(["g++", "-O1", "-std=c++17", "-pthread",
                    "-fsanitize=thread", "-DHNSW_TSAN_MAIN", H._SRC, "-o",
                    exe], check=True, capture_output=True, timeout=180)
    r = subprocess.run([exe], capture_output=True, timeout=300)
    assert r.returncode == 0, (r.returncode, r.stderr[-2000:])


def test_library_builds_into_port_build_dir():
    assert os.path.dirname(H._SO).endswith(os.path.join("nafp_tpu_torch",
                                                        "_build"))
    assert H._SRC == os.path.join(os.path.dirname(H.__file__), "hnsw.cc")
    H._load()
    assert os.path.exists(H._SO)


def test_factory_hnsw_and_cache_registry(rng):
    db = _unit(rng, 300)
    idx = P.get_index("hnsw", db, ef_search=77, device="cpu")
    assert isinstance(idx, HNSWIndex) and idx.ef_search == 77
    assert idx.ntotal == 0              # evaluate adds the rows
    assert P.cacheable_cls("hnsw") == (None, None)
    assert P.cacheable_cls("ivf-sq8", nprobe=9) == (P.IVFSQ8Index,
                                                   {"nprobe": 9})
    from nafp_tpu_torch.search.sharded import ShardedIVFSQ8Index
    assert P.cacheable_cls("ivf-sq8-sharded", nprobe=9) == (
        ShardedIVFSQ8Index, {"nprobe": 9})


def test_cli_ef_search_reaches_hnsw(rng, tmp_path, monkeypatch):
    from nafp_tpu_torch.cli import main
    from nafp_tpu_torch.configuration import load_config
    from nafp_tpu_torch.data.audio_io import create_memmap
    emb = tmp_path / "emb" / "run" / "1"
    db = _unit(rng, 400, 16)
    query = db + 0.02 * rng.standard_normal(db.shape).astype(np.float32)
    for key, a in (("dummy_db", _unit(rng, 600, 16)), ("db", db),
                   ("query", query)):
        mm = create_memmap(str(emb), key, a.shape)
        mm[:] = a
        mm.flush()
    cfg = load_config("default")
    cfg["DIR"]["OUTPUT_ROOT_DIR"] = str(tmp_path / "emb") + "/"
    cfg_path = str(tmp_path / "c.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    seen = []
    orig = HNSWIndex.search

    def spy(self, q, k, ef_search=None):
        seen.append(self.ef_search)
        return orig(self, q, k, ef_search)
    monkeypatch.setattr(HNSWIndex, "search", spy)
    res = CliRunner().invoke(main, [
        "evaluate", "run", "1", "-c", cfg_path, "-i", "hnsw", "-t", "30",
        "--test_seq_len", "1 3", "--ef_search", "33", "--nogpu"])
    assert res.exit_code == 0, res.output + repr(res.exception)
    assert seen and set(seen) == {33}
    raw = np.load(str(emb / "raw_score.npy"))
    assert raw.shape == (30, 8) and raw[:, 0].mean() > 0.5
