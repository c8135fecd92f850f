"""Port parity: the ICASSP sequence-search protocol of nafp_tpu_torch
against the JAX package's (both on the CPU): candidate scoring, the whole
evaluation on the same memmaps (identical raw_score.npy), and the copied
test-id asset."""
import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nafp_tpu.search.evaluate as JE
import nafp_tpu_torch.search.evaluate as PE
from nafp_tpu.data.audio_io import create_memmap, load_memmap

CPU = torch.device("cpu")


def test_score_candidates_matches_jax(rng):
    recon = rng.standard_normal((500, 16)).astype(np.float32)
    q_seq = rng.standard_normal((4, 3, 16)).astype(np.float32)
    cands = rng.integers(-1, 500, (4, 12))
    cands[1, :4] = cands[1, 4]                    # duplicates
    n_seg = np.array([3, 3, 2, 3], np.int32)
    q_seq[2, 2:] = 0.0
    js, jc = JE._score_candidates(jnp.asarray(q_seq), jnp.asarray(cands),
                                  jnp.asarray(recon), 3, jnp.asarray(n_seg))
    ps, pc = PE._score_candidates(torch.from_numpy(q_seq),
                                  torch.from_numpy(cands),
                                  torch.from_numpy(recon), 3,
                                  torch.from_numpy(n_seg))
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    js, ps = np.asarray(js), ps.numpy()
    np.testing.assert_array_equal(np.isfinite(ps), np.isfinite(js))
    fin = np.isfinite(js)
    # f32 sums of 3x16 products in other orders
    np.testing.assert_allclose(ps[fin], js[fin], rtol=1e-5, atol=1e-6)
    hs, hc = PE._score_candidates_host(q_seq, cands, recon, 3, n_seg)
    np.testing.assert_array_equal(hc, pc.numpy())
    np.testing.assert_allclose(hs[fin], ps[fin], rtol=1e-5, atol=1e-6)


def test_tail_query_scores_truncated_window(rng):
    """A tail test id with n_seg < sl still matches its ground-truth window
    at the DB end (the JAX package's regression case)."""
    n, d, sl = 100, 16, 5
    recon = rng.standard_normal((n, d)).astype(np.float32)
    recon /= np.linalg.norm(recon, axis=1, keepdims=True)
    n_seg = np.array([2], np.int32)
    q_seq = np.zeros((1, sl, d), np.float32)
    q_seq[0, :2] = recon[98:100]
    cands = np.array([[98, 50, 10, -1]], np.int32)
    js, jc = JE._score_candidates(jnp.asarray(q_seq), jnp.asarray(cands),
                                  jnp.asarray(recon), sl, jnp.asarray(n_seg))
    ps, pc = PE._score_candidates(
        torch.from_numpy(q_seq), torch.from_numpy(cands.astype(np.int64)),
        torch.from_numpy(recon), sl, torch.from_numpy(n_seg))
    ps, pc = ps.numpy(), pc.numpy()
    np.testing.assert_array_equal(pc, np.asarray(jc))
    gt = int(np.where(pc[0] == 98)[0][0])
    assert np.isfinite(ps[0, gt]) and int(np.argmax(ps[0])) == gt
    np.testing.assert_allclose(ps[0, gt], 1.0, rtol=1e-5)
    fin = np.isfinite(np.asarray(js))
    np.testing.assert_array_equal(np.isfinite(ps), fin)
    np.testing.assert_allclose(ps[fin], np.asarray(js)[fin], rtol=1e-5)


def test_top10_ties_go_to_lower_slot():
    """Equal sequence scores rank by candidate slot, as jax.lax.top_k."""
    scores = torch.tensor([[0.5, 0.9, 0.9, -float("inf"), 0.9]])
    v, pos = PE.topk_low_index(scores, 4)
    np.testing.assert_array_equal(pos.numpy(), [[1, 2, 4, 0]])


def test_icassp_asset_matches_jax():
    a = np.load(PE._icassp_asset_path())
    b = np.load(JE._icassp_asset_path())
    assert a.dtype == b.dtype and a.shape == b.shape == (2000,)
    np.testing.assert_array_equal(a, b)


def test_merged_recon_never_mutates_dummy(tmp_path, rng, monkeypatch):
    dummy = rng.standard_normal((300, 8)).astype(np.float32)
    keep = dummy.copy()
    db = rng.standard_normal((70, 8)).astype(np.float32)
    ref = np.concatenate([dummy, db])
    np.testing.assert_array_equal(PE._merged_recon(str(tmp_path), dummy, db),
                                  ref)
    monkeypatch.setattr(PE, "MERGE_RAM_LIMIT", 0)
    out = PE._merged_recon(str(tmp_path), dummy, db)
    assert isinstance(out, np.memmap)
    np.testing.assert_array_equal(np.asarray(out), ref)
    np.testing.assert_array_equal(dummy, keep)


def test_test_id_modes(tmp_path):
    np.testing.assert_array_equal(PE._test_ids("all", 30, 5, 0),
                                  np.arange(25))
    drawn = PE._test_ids("7", 30, 5, 42)
    assert len(drawn) == 7 and len(set(drawn)) == 7 and drawn.max() < 25
    p = str(tmp_path / "ids.npy")
    np.save(p, np.array([3, 1, 2]))
    np.testing.assert_array_equal(PE._test_ids(p, 30, 5, 0), [3, 1, 2])
    assert len(PE._test_ids("icassp", 30, 5, 0)) == 2000


@pytest.fixture(scope="module")
def memmaps(tmp_path_factory):
    """Seeded fingerprint memmaps: a dummy DB, a DB, and queries that are
    noisy copies of the DB rows (unit norm, d 32)."""
    root = str(tmp_path_factory.mktemp("emb"))
    rng = np.random.default_rng(7)

    def unit(x):
        return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(
            np.float32)

    db = unit(rng.standard_normal((160, 32)))
    parts = {"dummy_db": unit(rng.standard_normal((400, 32))), "db": db,
             "query": unit(db + 0.45 * rng.standard_normal(db.shape))}
    for key, arr in parts.items():
        mm = create_memmap(root, key, arr.shape)
        mm[:] = arr
        mm.flush()
    return root


@pytest.mark.parametrize("index_type", ["l2", "sq8"])
def test_eval_raw_score_identical(memmaps, tmp_path, index_type):
    dirs = {}
    for tag in ("jax", "torch"):
        dirs[tag] = str(tmp_path / tag)
        shutil.copytree(memmaps, dirs[tag])
    kw = dict(index_type=index_type, test_ids="all", test_seq_len="1 3 5")
    jr = JE.eval_fingerprints(dirs["jax"], **kw)
    pr = PE.eval_fingerprints(dirs["torch"], device=CPU, **kw)
    np.testing.assert_array_equal(pr, jr)
    for name in ("raw_score.npy", "test_ids.npy"):
        a = np.load(os.path.join(dirs["torch"], name))
        b = np.load(os.path.join(dirs["jax"], name))
        np.testing.assert_array_equal(a, b, err_msg=name)
    raw = np.load(os.path.join(dirs["torch"], "raw_score.npy"))
    assert raw.shape == (155, 12) and 0 < raw.mean() < 1  # neither trivial
    with open(os.path.join(dirs["torch"], "eval_summary.json")) as f:
        summary = json.load(f)
    assert summary["index_type"] == index_type and summary["n_db"] == 560


def test_eval_host_rescoring_matches_device(memmaps, tmp_path, monkeypatch):
    """Past the device budget the host scorer gives the same raw_score."""
    out = {}
    for tag, budget in (("dev", None), ("host", 0)):
        d = str(tmp_path / tag)
        shutil.copytree(memmaps, d)
        if budget is not None:
            monkeypatch.setattr(PE, "device_recon_budget",
                                lambda device: budget)
        PE.eval_fingerprints(d, index_type="l2", test_ids="all",
                             test_seq_len="1 3", device=CPU)
        out[tag] = np.load(os.path.join(d, "raw_score.npy"))
    np.testing.assert_array_equal(out["host"], out["dev"])


@pytest.mark.parametrize("index_type", [None, "ivfpq-rr"],
                         ids=["default-ivfpq", "ivfpq-rr"])
def test_eval_ivfpq_raw_score_identical(memmaps, tmp_path, monkeypatch,
                                        index_type):
    """The CLI default (-i ivfpq) and ivfpq-rr: both packages' evaluate on
    the same memmaps give one raw_score.npy. Training draws differ between
    the packages, so both IVFPQIndex.train install the same seeded numpy
    centroids (noisy DB rows) and codebooks; the decode chunk is shrunk so
    the JAX package's CPU one-hot decode stays small (its nlist-256 store
    holds at least 256 * 128 rows)."""
    import nafp_tpu.search.index as JI
    import nafp_tpu_torch.search.index as PI

    full = np.concatenate([np.asarray(load_memmap(memmaps, k,
                                                  display=False)[0])
                           for k in ("dummy_db", "db")])
    rng = np.random.default_rng(11)
    cents = (full[rng.choice(len(full), 256, replace=False)]
             + 0.05 * rng.standard_normal((256, 32))).astype(np.float32)
    books = (0.05 * rng.standard_normal((16, 256, 2))).astype(np.float32)

    def train_jax(self, data, **_):
        self.centroids, self.codebooks = jnp.asarray(cents), jnp.asarray(books)
        self._trained = True

    def train_torch(self, data, **_):
        self.centroids = torch.from_numpy(cents).to(self.device)
        self.codebooks = torch.from_numpy(books).to(self.device)
        self._trained = True
    monkeypatch.setattr(JI.IVFPQIndex, "train", train_jax)
    monkeypatch.setattr(PI.IVFPQIndex, "train", train_torch)
    monkeypatch.setattr(JI.IVFPQIndex, "CHUNK_ROWS", 8192)
    monkeypatch.setattr(PI.IVFPQIndex, "CHUNK_ROWS", 8192)

    dirs = {}
    for tag in ("jax", "torch"):
        dirs[tag] = str(tmp_path / tag)
        shutil.copytree(memmaps, dirs[tag])
    kw = dict(test_ids="all", test_seq_len="1 3 5")
    if index_type:
        kw["index_type"] = index_type
    jr = JE.eval_fingerprints(dirs["jax"], **kw)
    pr = PE.eval_fingerprints(dirs["torch"], device=CPU, **kw)
    np.testing.assert_array_equal(pr, jr)
    for name in ("raw_score.npy", "test_ids.npy"):
        a = np.load(os.path.join(dirs["torch"], name))
        b = np.load(os.path.join(dirs["jax"], name))
        np.testing.assert_array_equal(a, b, err_msg=name)
    raw = np.load(os.path.join(dirs["torch"], "raw_score.npy"))
    assert raw.shape == (155, 12) and 0 < raw.mean() < 1  # neither trivial
    with open(os.path.join(dirs["torch"], "eval_summary.json")) as f:
        summary = json.load(f)
    assert summary["index_type"] == (index_type or "ivfpq")
    assert summary["nprobe"] == 40
