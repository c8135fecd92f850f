"""Kernels B4a (``run_variant``) and B4b (``run_dotonly``) of the sq8 kernel
micro-bench: the port's plain versions against the JAX bench's Pallas
kernels in interpret mode (CPU), the wrappers' CPU route and argument
checks, the entry point with ``--nogpu``, and, marked ``gpu``, each CUDA
kernel against its plain version on the card (skipped without one).

Tolerances. Products of bf16-rounded (or f32) queries with int8 rows are
exact in f32; only the order of the f32 sums differs between XLA and
PyTorch, so raw sums (magnitude up to ~300) agree within RAW_ATOL and
scaled scores (magnitude ~1) within SCORE_ATOL. The ``int8_dot`` path sums
integers exactly on both sides, but XLA computes the query scale
``max|q| / 127`` as ``max|q| * (1 / 127)``, which can differ from the
division by one rounding; its scores then differ by at most about two f32
roundings, so they are held within INT8_RTOL (relative: the empty slots
hold NEG times the query scale, ~-2e27). Ids are equal except at exact
ties, where the scores at both ids are equal.
"""
import functools
import importlib.util
import os
import sys
import types

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from nafp_tpu_torch.extras import bench_sq8_kernel as B
from nafp_tpu_torch.search import topk as T

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEG = -1e30
RAW_ATOL = 1e-3
SCORE_ATOL = 1e-5
INT8_RTOL = 1e-6
BLK = 256


@pytest.fixture(scope="module")
def jax_bench():
    """extras/bench_sq8_kernel.py loaded from its path, with its Pallas
    calls in interpret mode. Loading it sets JAX_COMPILATION_CACHE_DIR and
    puts the repository root on sys.path; both are restored."""
    env, path = dict(os.environ), list(sys.path)
    try:
        spec = importlib.util.spec_from_file_location(
            "jax_bench_sq8_kernel",
            os.path.join(REPO, "extras", "bench_sq8_kernel.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        os.environ.clear()
        os.environ.update(env)
        sys.path[:] = path
    mod.pl = types.SimpleNamespace(
        **{name: getattr(pl, name) for name in dir(pl)
           if not name.startswith("_")})
    mod.pl.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    return mod


def _store(rng, n, case="plain", d=128):
    """int8 rows, row scales in [0.9, 1.1] / 127 and a 0 / NEG row mask,
    as the bench makes them, with the case's masked rows."""
    v8 = rng.integers(-127, 128, (n, d)).astype(np.int8)
    sc = (rng.uniform(0.9, 1.1, n) / 127).astype(np.float32)
    rm = np.zeros(n, np.float32)
    if case == "tombstones":
        rm[rng.random(n) < 0.05] = NEG
    if case == "all_negative":
        v8 = np.abs(v8.astype(np.int16)).astype(np.int8)
    if case in ("k_gt_valid", "int8_k_gt_valid"):
        rm[:] = NEG
        rm[rng.choice(n, 3, replace=False)] = 0.0
    return v8, sc, rm


def _queries(rng, bq, v8, sc, case="plain"):
    """Unit queries near randomly picked rows (0.05 noise), as the bench
    makes them; all-negative scores for that case."""
    pick = rng.integers(0, len(v8), bq)
    q = v8[pick].astype(np.float32) * sc[pick, None] + 0.05 * (
        rng.standard_normal((bq, v8.shape[1])).astype(np.float32))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    if case == "all_negative":
        q = -np.abs(q)
    return q.astype(np.float32)


def _check_topk(got_v, got_i, want_v, want_i, sim, int8_dot=False):
    """-1 at the same slots; scores within SCORE_ATOL (int8_dot:
    INT8_RTOL); a position that differs is an exact tie (equal scores at
    both)."""
    got_v, got_i = np.asarray(got_v), np.asarray(got_i)
    want_v, want_i = np.asarray(want_v), np.asarray(want_i)
    assert got_i.dtype == np.int32 and got_v.shape == want_v.shape
    np.testing.assert_array_equal(got_i < 0, want_i < 0)
    if int8_dot:
        np.testing.assert_allclose(got_v, want_v, rtol=INT8_RTOL, atol=0)
    else:
        np.testing.assert_allclose(got_v, want_v, rtol=0, atol=SCORE_ATOL)
    differ = (want_i >= 0) & (got_i != want_i)
    at = np.take_along_axis(sim, np.maximum(got_i, 0).astype(np.int64), 1)
    ref = np.take_along_axis(sim, np.maximum(want_i, 0).astype(np.int64), 1)
    np.testing.assert_array_equal(at[differ], ref[differ])


def _sim(q, v8, sc, rm, int8_dot):
    """f64 scores of every (query, row): f32 queries, or the int8 ones with
    their scale (ranking order of the int8 path)."""
    if int8_dot:
        q8, qs = B.quantize_queries(torch.from_numpy(q))
        return ((q8.double().numpy() @ v8.T.astype(np.float64)) * sc + rm) \
            * qs.double().numpy()[:, None]
    return (q.astype(np.float64) @ v8.T.astype(np.float64)) * sc + rm


def test_b4b_plain_matches_jax_last_block(jax_bench, rng):
    """The reference's run_dotonly returns the LAST block's maximum; the
    plain version keeps every block's, and its last column is that."""
    n, bq = 3 * BLK, 8
    v8, sc, rm = _store(rng, n)
    q = _queries(rng, bq, v8, sc)
    want = np.asarray(jax_bench.run_dotonly(q, v8, sc, rm, blk=BLK))
    got = B.run_dotonly_plain(torch.from_numpy(q), torch.from_numpy(v8), BLK)
    assert want.shape == (bq, 1) and got.shape == (bq, n // BLK)
    np.testing.assert_allclose(got.numpy()[:, -1:], want, rtol=0,
                               atol=RAW_ATOL)
    qb = torch.from_numpy(q).to(torch.bfloat16).double().numpy()
    sim = qb @ v8.T.astype(np.float64)
    blocks = sim.reshape(bq, n // BLK, BLK).max(axis=2)
    np.testing.assert_allclose(got.numpy(), blocks, rtol=0, atol=RAW_ATOL)
    # the reference's quirk, pinned: not the maximum over all N
    assert (want[:, 0] < sim.max(axis=1) - 1.0).any()


VARIANT_CASES = [
    pytest.param(mode, case, 20, 128, id=f"{mode}-{case}") for mode, case in [
        ("v0", "plain"), ("v2", "plain"), ("bcast", "plain"),
        ("int8", "plain"), ("v0", "tombstones"), ("v2", "tombstones"),
        ("int8", "tombstones"), ("v0", "all_negative"),
        ("v2", "all_negative"), ("int8", "all_negative"),
        ("v0", "k_gt_valid"), ("v2", "k_gt_valid")]
] + [
    # the kernel's larger k, its second K extent (d 256) and its narrow row
    # copies (d 20; int8 queries take multiples of 16)
    ("v0", "tombstones", 80, 256), ("v2", "tombstones", 80, 256),
    ("int8", "tombstones", 80, 256), ("v0", "all_negative", 128, 20),
    ("v2", "all_negative", 128, 20), ("int8", "all_negative", 128, 16),
    ("v0", "k_gt_valid", 80, 256), ("v2", "k_gt_valid", 128, 20),
]
# the reference's modes: v0, its bench variants v2, bcast and int8, and
# the port's v3 (B2's insertion in B4a; the same function as bcast)
MODES = {"v0": dict(merge_mode="v0"),
         "bcast": dict(scale_mode="bcast", merge_mode="v3"), **B.VARIANTS}


@pytest.mark.parametrize("mode,case,k,d", VARIANT_CASES)
def test_b4a_plain_matches_jax(jax_bench, rng, mode, case, k, d):
    """Plain B4a (f32 q, the reference's interpret-mode numerics) against
    the reference's run_variant in interpret mode, with tombstones,
    all-negative scores and k larger than the valid rows, at k up to 128
    and d 16 to 256."""
    n, bq = 4 * BLK, 24
    v8, sc, rm = _store(rng, n, case, d)
    q = _queries(rng, bq, v8, sc, case)
    kw = MODES[mode]
    int8_dot = kw.get("int8_dot", False)
    want_v, want_i = jax_bench.run_variant(q, v8, sc, rm, k=k, blk=BLK,
                                           interpret=True, **kw)
    got_v, got_i = B.run_variant_plain(
        torch.from_numpy(q), torch.from_numpy(v8), torch.from_numpy(sc),
        torch.from_numpy(rm), k, int8_dot=int8_dot)
    _check_topk(got_v, got_i, want_v, want_i, _sim(q, v8, sc, rm, int8_dot),
                int8_dot)
    got_i = got_i.numpy()
    assert not (rm[got_i[got_i >= 0]] < 0).any()
    if case == "all_negative":
        assert (got_v.numpy() < 0).all() and (got_i >= 0).all()
    if case == "k_gt_valid":
        assert (got_i[:, :3] >= 0).all() and (got_i[:, 3:] == -1).all()


def test_b4a_int8_fewer_valid_rows_than_k(jax_bench, rng):
    """With int8_dot and fewer valid rows than k the reference scales the
    empty slots' NEG before its -1 test, so they keep a (repeated)
    position; the port returns the same scores and -1 there."""
    n, bq, k = 2 * BLK, 6, 8
    v8, sc, rm = _store(rng, n, "int8_k_gt_valid")
    q = _queries(rng, bq, v8, sc)
    want_v, want_i = (np.asarray(a) for a in jax_bench.run_variant(
        q, v8, sc, rm, k=k, blk=BLK, interpret=True, int8_dot=True))
    got_v, got_i = (a.numpy() for a in B.run_variant_plain(
        torch.from_numpy(q), torch.from_numpy(v8), torch.from_numpy(sc),
        torch.from_numpy(rm), k, int8_dot=True))
    np.testing.assert_allclose(got_v, want_v, rtol=INT8_RTOL, atol=0)
    np.testing.assert_array_equal(got_i[:, :3], want_i[:, :3])
    assert (got_v[:, 3:] > NEG / 2).all()          # NEG times the q scale
    assert (want_i[:, 3:] >= 0).all() and (got_i[:, 3:] == -1).all()


def test_wrappers_cpu_route_is_plain(rng):
    """On CPU tensors every wrapper mode is the plain version (f32 q), and
    no kernel launch is counted."""
    n = 4 * BLK
    v8, sc, rm = _store(rng, n, "tombstones")
    args = [torch.from_numpy(a) for a in (_queries(rng, 16, v8, sc), v8, sc,
                                          rm)]
    B.reset_launches()
    T.reset_launches()
    for kw in MODES.values():
        got = B.run_variant(*args, k=12, blk=BLK, **kw)
        want = B.run_variant_plain(*args, k=12,
                                   int8_dot=kw.get("int8_dot", False))
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    blocks = B.run_dotonly_plain(args[0], args[1], BLK)
    assert torch.equal(B.run_dotonly(*args, blk=BLK, all_blocks=True), blocks)
    assert torch.equal(B.run_dotonly(*args, blk=BLK), blocks[:, -1:])
    assert torch.equal(B.dotonly_blocks(args[0], args[1], BLK), blocks)
    assert B.LAUNCHES == {"run_variant": 0, "run_dotonly": 0}
    assert set(T.LAUNCHES.values()) == {0}


def test_wrappers_reject_bad_arguments():
    q, v8 = torch.zeros(2, 128), torch.zeros(512, 128, dtype=torch.int8)
    sc, rm = torch.zeros(512), torch.zeros(512)
    with pytest.raises(ValueError, match="k=129"):
        B.run_variant(q, v8, sc, rm, k=129, blk=BLK)
    with pytest.raises(ValueError, match="k=0"):
        B.run_variant(q, v8, sc, rm, k=0, blk=BLK)
    with pytest.raises(ValueError, match="merge_mode"):
        B.run_variant(q, v8, sc, rm, blk=BLK, merge_mode="v4")
    with pytest.raises(ValueError, match="scale_mode"):
        B.run_variant(q, v8, sc, rm, blk=BLK, scale_mode="rows")
    with pytest.raises(ValueError, match="blk=384"):
        B.run_variant(q, v8, sc, rm, blk=384)          # does not divide N
    with pytest.raises(ValueError, match="blk=64"):
        B.run_dotonly(q, v8, sc, rm, blk=64)           # not a multiple of 128


def test_main_nogpu_prints_results(capsys):
    """The entry point on the CPU: plain versions at a tiny N, every
    variant's agreement with v0 printed, then the results dict."""
    res = B.main(["--nogpu", "--n", "2048", "--bq", "8", "--blk", "256",
                  "--reps", "1"])
    out = capsys.readouterr().out.strip().splitlines()
    assert set(res) == {"dotonly", "v0", "v3", "v2", "int8"}
    assert out[-1].startswith("{'dotonly': ") and "'int8': " in out[-1]
    assert any(line.startswith("v2 ") and "ids-agree 1.0000" in line
               for line in out)
    assert res["v2"]["ids_agree"] == res["v3"]["ids_agree"] == 1.0
    assert res["int8"]["top1"] == 1.0
    with pytest.raises(SystemExit):
        B.main(["--nogpu", "--variants", "v9"])


def _check_card(v, i, pv, pi, sim, int8_dot, case):
    """A B4a kernel's result against its plain version on the card. int8:
    exact s32 sums, so scores and ids equal the plain version's exactly.
    bf16: products summed in f32 in the tensor cores' order, so ids equal
    but at near-ties: -1 at the same slots, scores within SCORE_ATOL, the
    f64 scores at the kernel's ids within SCORE_ATOL of the plain scores.
    Twins (rows n/2 apart repeating each other): with a row, its lower
    twin."""
    got = i.cpu().numpy()
    if int8_dot:
        assert torch.equal(v, pv) and torch.equal(i, pi)
    else:
        want_v, want_i = pv.cpu().numpy(), pi.cpu().numpy()
        np.testing.assert_array_equal(got < 0, want_i < 0)
        ok = want_i >= 0
        np.testing.assert_allclose(v.cpu().numpy()[ok], want_v[ok], rtol=0,
                                   atol=SCORE_ATOL)
        at = np.take_along_axis(sim, np.maximum(got, 0).astype(np.int64), 1)
        np.testing.assert_allclose(at[ok], want_v[ok], rtol=0,
                                   atol=SCORE_ATOL)
    if case == "twins":
        half = sim.shape[1] // 2
        for row in got:
            assert np.isin(row[row >= half] - half, row).all()


@pytest.mark.gpu
def test_kernels_match_plain_on_gpu():
    """B4a (v3, bcast, v2, int8) and B4b against their plain versions on
    the card (bf16 q, the kernels' numerics): tombstones at k 20 / 80 /
    128, every score negative, k > valid rows, d 256 and d 20 (int8: 16),
    and twin rows in other chunks; the launch counters count the kernel
    calls."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    B.reset_launches()
    n = 32 * 2048
    v8, sc, rm = _store(rng, n, "tombstones")
    q = _queries(rng, 200, v8, sc)
    args = [torch.from_numpy(a).to(dev) for a in (q, v8, sc, rm)]
    all_k = [("v3", 20), ("bcast", 20), ("v2", 20), ("v2", 80),
             ("int8", 20), ("v3", 80), ("int8", 80), ("v3", 128),
             ("v2", 128), ("int8", 128)]
    bf16_only = [("v3", 80), ("v2", 128)]
    cases = [(args, "tombstones", all_k)]
    for case, d, bq, names in [
            ("tombstones", 256, 100, [("v3", 80), ("v2", 80), ("int8", 80)]),
            ("tombstones", 20, 100, bf16_only),
            ("tombstones", 16, 100, [("int8", 128)]),
            ("all_negative", 128, 64, [("v3", 128), ("v2", 80),
                                       ("int8", 80)]),
            ("k_gt_valid", 128, 9, [("v3", 48), ("v2", 48)]),
            ("twins", 128, 128, [("v3", 80), ("v2", 80), ("int8", 41)])]:
        v8x, scx, rmx = _store(rng, 8192, "plain" if case == "twins"
                               else case, d)
        if case == "twins":
            v8x[4096:], scx[4096:] = v8x[:4096], scx[:4096]
        qx = _queries(rng, bq, v8x, scx, case)
        cases.append(([torch.from_numpy(a).to(dev)
                       for a in (qx, v8x, scx, rmx)], case, names))
    n_variant = 0
    for xs, case, names in cases:
        v8x, scx, rmx = (a.cpu().numpy() for a in xs[1:])
        for name, k in names:
            kw = MODES[name]
            int8_dot = kw.get("int8_dot", False)
            v, i = B.run_variant(*xs, k=k, **kw)
            pv, pi = B.run_variant_plain(*xs, k=k, int8_dot=int8_dot,
                                         compute_dtype=torch.bfloat16)
            qn = xs[0].cpu().numpy() if int8_dot else (
                xs[0].to(torch.bfloat16).float().cpu().numpy())
            _check_card(v, i, pv, pi, _sim(qn, v8x, scx, rmx, int8_dot),
                        int8_dot, case)
            n_variant += 1
    got = B.run_dotonly(*args, all_blocks=True)
    want = B.run_dotonly_plain(args[0], args[1])
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=0, atol=RAW_ATOL)
    assert torch.equal(B.run_dotonly(*args), got[:, -1:])
    # 512 blocks of 128 rows over one wave of CTAs: several blocks per CTA;
    # and 300 queries: two query blocks, the second ragged
    q300 = torch.from_numpy(_queries(rng, 300, v8, sc)).to(dev)
    # d 256 (the second K extent: 128 queries per CTA) and d 20 (4-byte
    # row copies)
    v8_256, v8_20 = (torch.from_numpy(
        rng.integers(-127, 128, (n, d)).astype(np.int8)).to(dev)
        for d in (256, 20))
    q256, q20 = (torch.nn.functional.normalize(torch.from_numpy(
        rng.standard_normal((300, d)).astype(np.float32)), dim=1).to(dev)
        for d in (256, 20))
    for qx, v8x, blk in ((args[0], args[1], 128), (q300, args[1], 128),
                         (q300, args[1], 2048), (q256, v8_256, 128),
                         (q20, v8_20, 2048)):
        got = B.dotonly_blocks(qx, v8x, blk)
        want = B.run_dotonly_plain(qx, v8x, blk)
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=0, atol=RAW_ATOL)
    assert B.LAUNCHES == {"run_variant": n_variant, "run_dotonly": 7}
