"""The port's search measurement entry points against the JAX package's,
on the CPU: ``nafp_tpu_torch/extras/run_100x_protocol.py`` (the DB, the
queries and the exact host ground truth byte for byte; the int8 stores
written by either package load in the other and search to the same ids;
``--gt device`` through kernel B1's plain version) and
``nafp_tpu_torch/bench_search.py --suite``."""
import importlib.util
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nafp_tpu.search import index as JI
from nafp_tpu_torch import bench_search as PB
from nafp_tpu_torch.extras import run_100x_protocol as PP
from nafp_tpu_torch.search import index as PI
from test_torch_convergence import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
N, NQ = 20_000, 64


def _load_jax_script(name):
    """A script of ``extras/`` loaded from its path; the environment and
    sys.path it changes on import are restored."""
    env, path = dict(os.environ), list(sys.path)
    try:
        spec = importlib.util.spec_from_file_location(
            f"jax_{name}", os.path.join(REPO, "extras", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        os.environ.clear()
        os.environ.update(env)
        sys.path[:] = path
    return mod


@pytest.fixture(scope="module")
def JP():
    return _load_jax_script("run_100x_protocol")


@pytest.fixture(scope="module")
def roots(tmp_path_factory, JP):
    """One DB per package, each written by its own stage_gen."""
    out = {}
    for tag, mod in (("jax", JP), ("torch", PP)):
        out[tag] = str(tmp_path_factory.mktemp(tag))
        mod.stage_gen(out[tag], N, chunk=6_000)     # 4 chunks, one ragged
    return out


def test_db_queries_and_host_gt_are_the_jax_bytes(roots, JP):
    for name in ("dummy_db.mm", "dummy_db_shape.npy"):
        with open(os.path.join(roots["jax"], name), "rb") as a, \
                open(os.path.join(roots["torch"], name), "rb") as b:
            assert a.read() == b.read(), name
    jmm, pmm = JP.load_mm(roots["jax"]), PP.load_mm(roots["torch"])
    jq, jpick = JP.make_queries(jmm, NQ)
    pq, ppick = PP.make_queries(pmm, NQ)
    np.testing.assert_array_equal(pq, jq)
    np.testing.assert_array_equal(ppick, jpick)
    threads = torch.get_num_threads()
    try:        # the JAX helper pins torch to one thread
        jgt = JP.exact_gt_host(jmm, jq, roots["jax"], chunk=8192)
    finally:
        torch.set_num_threads(threads)
    pgt = PP.exact_gt_host(pmm, pq, roots["torch"], chunk=8192)
    for a, b in zip(pgt, jgt):
        np.testing.assert_array_equal(a, b)
    # either package's cache serves the other (the same key and format)
    for name in ("qhash", "n", "top1_i", "top1_v", "top2_v"):
        with np.load(os.path.join(roots["jax"], "exact_gt.npz")) as zj, \
                np.load(os.path.join(roots["torch"], "exact_gt.npz")) as zp:
            np.testing.assert_array_equal(zp[name], zj[name])
    np.testing.assert_array_equal(pgt[0], jpick)   # planted == exact here


def test_gt_device_equals_host_gt(roots):
    """``--gt device``: kernel B1 over uploaded chunks, here its plain
    version on the CPU, merged per chunk: the host GT's ids exactly."""
    mm = PP.load_mm(roots["torch"])
    q, _ = PP.make_queries(mm, NQ)
    host = PP.exact_gt_host(mm, q, roots["torch"], chunk=8192)[0]
    for chunk in (1 << 21, 7_000):          # one chunk; three, one ragged
        np.testing.assert_array_equal(
            PP.exact_gt_top1(mm, q, chunk=chunk, device=CPU), host)
    out = PP.main(["--n", str(N), "--nq", str(NQ), "--root", roots["torch"],
                   "--stages", "recall", "--index", "sq8", "--gt", "device",
                   "--cpu"])
    assert out["gt"] == "exact-streamed" and out["planted_agree"] == 1.0
    assert out["recall_at_k"] == 1.0 and out["device"] == "cpu"


@pytest.fixture
def injected_centroids(roots, monkeypatch):
    """Both packages' IVFSQ8Index.train install the same 256 seeded
    centroids (noisy DB rows): the k-means draws differ between them."""
    rng = np.random.default_rng(5)
    mm = PP.load_mm(roots["torch"])
    cents = np.asarray(mm[rng.choice(N, 256, replace=False)]) \
        + 0.05 * rng.standard_normal((256, 128)).astype(np.float32)

    def train_jax(self, data, **_):
        self.nlist, self.centroids = 256, jnp.asarray(cents)
        self._trained = True

    def train_torch(self, data, **_):
        self.nlist, self.centroids = 256, torch.from_numpy(cents)
        self._trained = True
    monkeypatch.setattr(JI.IVFSQ8Index, "train", train_jax)
    monkeypatch.setattr(PI.IVFSQ8Index, "train", train_torch)


@pytest.mark.parametrize("index", ["sq8", "ivf-sq8"])
def test_stores_load_both_ways(roots, JP, injected_centroids, index):
    """Each package's stage_build persists its store (equal arrays); the
    other package loads it, and all four indexes return the same ids."""
    name = {"sq8": "sq8_store.npz", "ivf-sq8": "ivfsq8_store.npz"}[index]
    loader = {"sq8": (JI.SQ8FlatIndex, PI.SQ8FlatIndex),
              "ivf-sq8": (JI.IVFSQ8Index, PI.IVFSQ8Index)}[index]
    jidx = JP.stage_build(roots["jax"], {}, index=index)
    pidx = PP.stage_build(roots["torch"], {}, index=index, device=CPU)
    with np.load(os.path.join(roots["jax"], name)) as zj, \
            np.load(os.path.join(roots["torch"], name)) as zp:
        assert sorted(zp.files) == sorted(zj.files)
        for key in zj.files:
            np.testing.assert_array_equal(zp[key], zj[key], err_msg=key)
    j_from_p = loader[0].load(os.path.join(roots["torch"], name))
    p_from_j = loader[1].load(os.path.join(roots["jax"], name), device=CPU)
    q, _ = PP.make_queries(PP.load_mm(roots["torch"]), NQ)
    ids = [ix.search(q, 20)[1] for ix in (jidx, pidx, j_from_p, p_from_j)]
    for other in ids[1:]:
        np.testing.assert_array_equal(other, ids[0])


def test_sq8_reuses_a_jax_ivfsq8_store(roots, JP, injected_centroids,
                                       tmp_path):
    """The port's sq8 build loads an ivf-sq8 store the JAX script
    persisted when it has no sq8 store of its own, as the JAX script
    does, and searches like the JAX package's sq8 on that store."""
    import shutil
    root = str(tmp_path)
    for name in ("dummy_db.mm", "dummy_db_shape.npy"):
        shutil.copy(os.path.join(roots["jax"], name), root)
    JP.stage_build(root, {}, index="ivf-sq8")
    out_j, out_p = {}, {}
    jidx = JP.stage_build(root, out_j, index="sq8")
    pidx = PP.stage_build(root, out_p, index="sq8", device=CPU)
    assert out_p == out_j == {"index": "sq8", "build_cached": True}
    assert not os.path.exists(os.path.join(root, "sq8_store.npz"))
    q, _ = PP.make_queries(PP.load_mm(root), NQ)
    np.testing.assert_array_equal(pidx.search(q, 20)[1],
                                  jidx.search(q, 20)[1])


def test_pq_decode_int8_raises(tmp_path, one_thread):
    """``--pq_decode int8`` is ported: the ivfpq build decodes from int8
    codebooks, on a fresh store and on the persisted one, where the flag
    is set after ``load`` (the JAX script's order); what still raises is
    a decode other than f32 / int8, before anything is built."""
    with pytest.raises(ValueError, match="pq_decode"):
        PP.stage_build(str(tmp_path), {}, index="ivfpq", pq_decode="int4")
    assert os.listdir(tmp_path) == []            # nothing was generated
    args = ["--n", "1024", "--nq", "16", "--root", str(tmp_path), "--index",
            "ivfpq", "--pq_decode", "int8", "--cpu"]
    fresh = PP.main(args)
    assert fresh["pq_decode"] == "int8" and "build_cached" not in fresh
    cached = PP.main(args + ["--stages", "build,qps,recall"])
    assert cached["pq_decode"] == "int8" and cached["build_cached"]
    idx = PP.stage_build(str(tmp_path), {}, index="ivfpq", pq_decode="int8",
                         device=CPU)
    assert idx.decode_int8 and idx._books_q_cache is None
    assert cached["recall_at_k"] == fresh["recall_at_k"] >= 0.9


def test_suite_rows_have_the_jax_keys(tmp_path):
    assert os.path.abspath(PB.DEFAULT_OUT) != os.path.join(
        REPO, "SEARCH_BENCH.json")
    assert PB.DEFAULT_OUT.startswith(os.path.join(REPO, "nafp_tpu_torch",
                                                  "measurements"))
    out = str(tmp_path / "suite.json")
    res = PB.main(["--suite", "--cpu", "--n", "4096", "--nq", "32",
                   "--hnsw_n", "1000", "--root", str(tmp_path / "root"),
                   "--out", out])
    with open(out) as f:
        assert json.load(f) == res
    assert res["backend"] == "cpu" and res["gt"] == "host-exact"
    assert [r["index"] for r in res["suite"]] == [
        "sq8", "ivfpq", "ivfpq-rr", "ivf-sq8", "hnsw", "hnsw", "hnsw"]
    base = {"metric", "index", "n", "value", "unit", "k", "recall_at_k"}
    for r in res["suite"]:
        assert base <= set(r) and r["metric"] == "search_qps"
        assert r["value"] > 0 and 0.0 <= r["recall_at_k"] <= 1.0
        if r["index"] in ("ivfpq", "ivfpq-rr", "ivf-sq8"):
            assert r["nprobe"] == 40
        if r["index"] == "hnsw":
            assert {"ef_search", "ef_construction"} <= set(r)
    assert res["suite"][0]["recall_at_k"] == 1.0     # sq8 is exact here
