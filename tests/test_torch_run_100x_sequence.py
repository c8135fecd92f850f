"""The port's sequence-level 100x runner
(``nafp_tpu_torch/extras/run_100x_sequence.py``) against the JAX
package's, on the CPU: the walk and query files byte for byte, and the
``eval`` stage (sq8) giving the JAX package's ``raw_score.npy`` and
``test_ids.npy`` on the same files (exact equality)."""
import importlib.util
import os
import shutil
import sys

import numpy as np
import pytest
import torch

import nafp_tpu.search.evaluate as JE
from nafp_tpu_torch.extras import run_100x_sequence as PS
from test_torch_convergence import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = ("dummy_db.mm", "dummy_db_shape.npy", "db.mm", "db_shape.npy",
         "query.mm", "query_shape.npy")


@pytest.fixture(scope="module")
def JS():
    """extras/run_100x_sequence.py loaded from its path; the environment
    and sys.path it changes on import are restored."""
    env, path = dict(os.environ), list(sys.path)
    try:
        spec = importlib.util.spec_from_file_location(
            "jax_run_100x_sequence",
            os.path.join(REPO, "extras", "run_100x_sequence.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        os.environ.clear()
        os.environ.update(env)
        sys.path[:] = path
    return mod


@pytest.fixture(scope="module")
def roots(tmp_path_factory, JS):
    """Each package's gen stage: 5 dummy songs of 536 segments (written in
    song chunks of 2, one ragged), 12 db songs of 59, their queries."""
    out = {}
    for tag, mod in (("jax", JS), ("torch", PS)):
        root = str(tmp_path_factory.mktemp(tag))
        rng = np.random.default_rng(2024)
        mod._write_walks(os.path.join(root, "dummy_db"), 5, 536, 0.7, rng,
                         song_chunk=2)
        mod._write_walks(os.path.join(root, "db"), 12, 59, 0.7, rng)
        mod._write_queries(root, 12, 59, 0.066)
        out[tag] = root
    return out


def test_walks_and_queries_are_the_jax_bytes(roots):
    for name in FILES:
        with open(os.path.join(roots["jax"], name), "rb") as a, \
                open(os.path.join(roots["torch"], name), "rb") as b:
            assert a.read() == b.read(), name


def test_stage_gen_matches_jax_and_skips_when_done(tmp_path, JS):
    kw = dict(n_dummy_songs=3, dummy_segs=40, n_db_songs=4, db_segs=59,
              alpha=0.7, noise=0.066)
    for tag, mod in (("jax", JS), ("torch", PS)):
        os.makedirs(tmp_path / tag)
        mod.stage_gen(str(tmp_path / tag), **kw)
    for name in FILES + ("gen.done.json",):
        assert (tmp_path / "jax" / name).read_bytes() == \
            (tmp_path / "torch" / name).read_bytes(), name
    mtime = os.path.getmtime(tmp_path / "torch" / "dummy_db.mm")
    PS.stage_gen(str(tmp_path / "torch"), **dict(kw, noise=0.1))
    JS.stage_gen(str(tmp_path / "jax"), **dict(kw, noise=0.1))
    assert os.path.getmtime(tmp_path / "torch" / "dummy_db.mm") == mtime
    assert (tmp_path / "jax" / "query.mm").read_bytes() == \
        (tmp_path / "torch" / "query.mm").read_bytes()


def test_eval_sq8_raw_score_equals_jax(roots, tmp_path):
    """The port's eval stage (main, --cpu) and the JAX package's
    eval_fingerprints on one copy of the files each: the same
    raw_score.npy and test_ids.npy; both persist the sq8 store in the
    ivf-sq8 store file, as the JAX runner does."""
    dirs = {}
    for tag in ("jax", "torch"):
        dirs[tag] = str(tmp_path / tag)
        os.makedirs(dirs[tag])
        for name in FILES:
            shutil.copy(os.path.join(roots["torch"], name), dirs[tag])
    JE.eval_fingerprints(
        dirs["jax"], emb_dummy_dir=dirs["jax"], index_type="sq8",
        test_ids="16", nprobe=40,
        index_cache=os.path.join(dirs["jax"], "ivf-sq8_store.npz"))
    line = PS.main(["--root", dirs["torch"], "--stages", "eval", "--index",
                    "sq8", "--test_ids", "16", "--cpu"])
    for name in ("raw_score.npy", "test_ids.npy"):
        np.testing.assert_array_equal(
            np.load(os.path.join(dirs["torch"], name)),
            np.load(os.path.join(dirs["jax"], name)), err_msg=name)
    raw = np.load(os.path.join(dirs["torch"], "raw_score.npy"))
    assert raw.shape == (16, 24) and raw.mean() > 0.5
    assert line["protocol"] == "100x-sequence" and line["n_test"] == 16
    assert line["device"] == "cpu" and line["index_type"] == "sq8"
    for tag in ("jax", "torch"):
        assert os.path.exists(os.path.join(dirs[tag], "ivf-sq8_store.npz"))


def test_eval_kmeans_seed_leaves_the_runner_store_alone(roots, tmp_path,
                                                      one_thread):
    """``stage_eval``: k-means seed 0 persists the runner's ivf-sq8 store;
    another seed trains its own k-means (``get_index(seed=)``) and neither
    reads nor rewrites that file."""
    from nafp_tpu_torch.search.index import IVFSQ8Index, get_index
    d = str(tmp_path)
    for name in FILES:
        shutil.copy(os.path.join(roots["torch"], name), d)
    store = os.path.join(d, "ivf-sq8_store.npz")
    s0 = PS.stage_eval(d, "ivf-sq8", 8, "16", "cpu")
    with open(store, "rb") as f:
        before = f.read()
    s1 = PS.stage_eval(d, "ivf-sq8", 8, "16", "cpu", kmeans_seed=1)
    with open(store, "rb") as f:
        assert f.read() == before
    assert s0["n_test"] == s1["n_test"] == 16
    assert s0["index_type"] == s1["index_type"] == "ivf-sq8"
    db = np.array(np.memmap(os.path.join(d, "db.mm"), np.float32,
                            "r")).reshape(-1, 128)
    ref = IVFSQ8Index(d=128, nprobe=8, device="cpu")
    ref.train(db, seed=1)
    got = get_index("ivf-sq8", db, nprobe=8, device="cpu", seed=1)
    assert torch.equal(got.centroids, ref.centroids)
    assert not torch.equal(got.centroids, get_index(
        "ivf-sq8", db, nprobe=8, device="cpu").centroids)
