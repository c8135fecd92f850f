"""Kernels B1, B2 and B3: the plain PyTorch versions against the JAX
package's Pallas kernels in interpret mode (CPU), the wrappers' CPU route
and argument checks, and, marked ``gpu``, each CUDA kernel against its
plain version on the card (skipped without one)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nafp_tpu.search.index import _pq_score_chunk_xla
from nafp_tpu.search.pallas_topk import (topk_ip_pallas,
                                         topk_ip_pallas_masked,
                                         topk_ip_sq8_pallas)
from nafp_tpu_torch.search import topk as T

NEG = -1e30
ATOL = 1e-4   # scores, as tests/test_pallas_topk.py holds the TPU kernel
# B3 over a bf16 DB with bf16-rounded queries on both sides: the same
# products of bf16 values summed in f32 in other orders (XLA's interpret
# mode vs PyTorch); measured max |diff| 4.8e-7 over these cases at d 16-32
# with seeds 0-3.
BF16_ATOL = 1e-5


def _rand(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _quantize(x):
    sc = np.maximum(np.abs(x).max(axis=1), 1e-12) / 127.0
    q8 = np.clip(np.rint(x / sc[:, None]), -127, 127).astype(np.int8)
    return q8, sc.astype(np.float32)


def _check_same(got_v, got_i, want_v, want_i, sim):
    """Scores within ATOL, -1 at the same slots, and the scores at the
    returned ids equal the reference's (ids may differ on exact ties)."""
    got_v, got_i = np.asarray(got_v), np.asarray(got_i)
    want_v, want_i = np.asarray(want_v), np.asarray(want_i)
    np.testing.assert_allclose(got_v, want_v, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(got_i < 0, want_i < 0)
    valid = want_i >= 0
    at = np.take_along_axis(sim, np.maximum(got_i, 0).astype(np.int64), 1)
    np.testing.assert_allclose(at[valid], want_v[valid], atol=ATOL, rtol=0)


@pytest.mark.parametrize("bq,n,k,blk", [
    (8, 1000, 8, 256),     # several blocks
    (8, 777, 16, 256),     # N not a multiple of the block
    (8, 200, 8, 256),      # a single block
    (5, 40, 64, 128),      # k > N: empty slots are NEG / -1
])
def test_b1_plain_matches_pallas(rng, bq, n, k, blk):
    q, db = _rand(rng, (bq, 128)), _rand(rng, (n, 128))
    want_v, want_i = topk_ip_pallas(jnp.asarray(q), jnp.asarray(db), k=k,
                                    blk=blk, interpret=True)
    got_v, got_i = T.topk_ip(torch.from_numpy(q), torch.from_numpy(db), k)
    assert got_i.dtype == torch.int32 and got_v.shape == (bq, k)
    sim = q.astype(np.float64) @ db.T.astype(np.float64)
    _check_same(got_v, got_i, want_v, want_i, sim)
    assert (np.diff(got_v.numpy(), axis=1) <= 0).all()


def test_b1_negative_scores_beat_padding(rng):
    q = -np.abs(_rand(rng, (4, 16)))
    db = np.abs(_rand(rng, (100, 16)))
    want_v, want_i = topk_ip_pallas(jnp.asarray(q), jnp.asarray(db), k=8,
                                    blk=128, interpret=True)
    v, i = T.topk_ip(torch.from_numpy(q), torch.from_numpy(db), 8)
    assert ((i.numpy() >= 0) & (i.numpy() < 100)).all()
    assert (v.numpy() < 0).all()
    _check_same(v, i, want_v, want_i, q.astype(np.float64) @ db.T)


@pytest.mark.parametrize("bq,n,k,tomb", [
    (8, 4096, 20, 0.0),
    (8, 2048, 16, 0.05),   # tombstones inside the store
    (3, 2048, 20, 0.995),  # more masked rows than k: ids -1 past the valid
])
def test_b2_plain_matches_pallas(rng, bq, n, k, tomb):
    x = _rand(rng, (n, 128))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q8, sc = _quantize(x)
    dead = rng.random(n) < tomb
    if tomb > 0.9:
        dead[:] = True
        dead[:5] = False
    sc = np.where(dead, 0.0, sc).astype(np.float32)
    rmask = np.where(dead, NEG, 0.0).astype(np.float32)
    q = _rand(rng, (bq, 128))
    want_v, want_i = topk_ip_sq8_pallas(
        jnp.asarray(q), jnp.asarray(q8), jnp.asarray(sc), jnp.asarray(rmask),
        k=k, blk=1024, interpret=True)
    got_v, got_i = T.topk_ip_sq8(torch.from_numpy(q), torch.from_numpy(q8),
                                 torch.from_numpy(sc),
                                 torch.from_numpy(rmask), k)
    sim = (q.astype(np.float64) @ q8.T.astype(np.float64)) * sc + rmask
    _check_same(got_v, got_i, want_v, want_i, sim)
    assert not dead[got_i.numpy()[got_i.numpy() >= 0]].any()


def test_b2_plain_bf16_rounds_queries(rng):
    """compute_dtype=bf16 (the card's numerics) equals an f32 scan of the
    bf16-rounded queries."""
    q8, sc = _quantize(_rand(rng, (300, 128)))
    rmask = np.zeros(300, np.float32)
    q = torch.from_numpy(_rand(rng, (4, 128)))
    args = (torch.from_numpy(q8), torch.from_numpy(sc),
            torch.from_numpy(rmask), 10)
    v16, i16 = T.topk_ip_sq8_plain(q, *args, compute_dtype=torch.bfloat16)
    v32, i32 = T.topk_ip_sq8_plain(q.to(torch.bfloat16).float(), *args)
    np.testing.assert_array_equal(v16.numpy(), v32.numpy())
    np.testing.assert_array_equal(i16.numpy(), i32.numpy())


def test_topk_low_index_breaks_ties_by_lower_column():
    s = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0, 3.0],
                      [0.0, 0.0, 0.0, 0.0, 0.0, 0.0]])
    v, i = T.topk_low_index(s, 3)
    np.testing.assert_array_equal(i.numpy(), [[1, 2, 4], [0, 1, 2]])
    np.testing.assert_array_equal(v.numpy(), [[3, 3, 3], [0, 0, 0]])
    v, i = T.topk_low_index(s, 5)
    np.testing.assert_array_equal(i.numpy()[0], [1, 2, 4, 5, 3])


def test_wrappers_reject_bad_arguments():
    q, db = torch.zeros(2, 8), torch.zeros(10, 8)
    with pytest.raises(ValueError, match="k=129"):
        T.topk_ip(q, db, 129)
    with pytest.raises(ValueError, match="k=0"):
        T.topk_ip(q, db, 0)
    with pytest.raises(ValueError, match="k=200"):
        T.topk_ip_sq8(q, db.to(torch.int8), torch.zeros(10), torch.zeros(10),
                      200)


def test_launch_counters_untouched_on_cpu(rng):
    """The CPU route is the plain version: no kernel launch is counted."""
    T.reset_launches()
    T.topk_ip(torch.zeros(2, 8), torch.ones(10, 8), 3)
    T.topk_ip_masked(torch.zeros(2, 8),
                     torch.ones(128, 8, dtype=torch.bfloat16),
                     torch.arange(128, dtype=torch.int32),
                     torch.zeros(2, 2), 3, list_tile=64)
    assert T.LAUNCHES == {"topk_ip": 0, "topk_ip_sq8": 0,
                          "topk_ip_masked": 0}


def _masked_case(rng, bq, n, d, lt, case):
    """q, db (f32), ids (a permutation, -1 on masked rows) and the (Bq,
    N/lt) 0/NEG bias of one B3 case."""
    q, db = _rand(rng, (bq, d)), _rand(rng, (n, d))
    ids = rng.permutation(n).astype(np.int32)
    ids[rng.integers(0, n, n // 8)] = -1                  # interior invalid
    bias = np.where(rng.random((bq, n // lt)) < 0.5, 0.0, NEG).astype(
        np.float32)                                       # half masked
    if case == "unprobed_query":
        bias[0] = NEG
    if case == "k_gt_valid":
        ids[10:] = -1
    return q, db, ids, bias


MASKED_CASES = [
    # bq, n, d, blk, list_tile, k, case
    (8, 512, 32, 128, 64, 8, "interior"),
    (8, 512, 32, 256, 128, 8, "interior"),
    (4, 256, 16, 128, 64, 20, "unprobed_query"),
    (3, 256, 16, 128, 128, 40, "k_gt_valid"),
    (1, 256, 16, 128, 64, 5, "interior"),                 # Bq 1
]


@pytest.mark.parametrize("db_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("bq,n,d,blk,lt,k,case", MASKED_CASES)
def test_b3_plain_matches_pallas(rng, bq, n, d, blk, lt, k, case, db_dtype):
    """Plain B3 against topk_ip_pallas_masked in interpret mode: identical
    ids (mapped through the ids), -1 on masked and empty slots, scores on
    the valid slots within ATOL (f32 DB) or BF16_ATOL (bf16 DB; both sides
    then round q to bf16, as the TPU and the CUDA kernel do)."""
    q, db, ids, bias = _masked_case(rng, bq, n, d, lt, case)
    jdt, tdt = ((jnp.float32, torch.float32) if db_dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    want_v, want_i = topk_ip_pallas_masked(
        jnp.asarray(q), jnp.asarray(db).astype(jdt), jnp.asarray(ids),
        jnp.asarray(bias), k=k, blk=blk, list_tile=lt, interpret=True)
    want_v, want_i = np.asarray(want_v), np.asarray(want_i)
    got_v, got_i = T.topk_ip_masked_plain(
        torch.from_numpy(q), torch.from_numpy(db).to(tdt),
        torch.from_numpy(ids), torch.from_numpy(bias), k, lt,
        compute_dtype=tdt)
    got_v, got_i = got_v.numpy(), got_i.numpy()
    assert got_i.dtype == np.int32 and got_v.shape == (bq, k)
    np.testing.assert_array_equal(got_i, want_i)
    valid = want_i >= 0
    np.testing.assert_allclose(got_v[valid], want_v[valid], rtol=0,
                               atol=ATOL if db_dtype == "f32" else BF16_ATOL)
    assert not np.isin(got_i[valid], ids[ids < 0]).any()
    if case == "unprobed_query":
        assert (got_i[0] == -1).all() and valid[1:].any()
    if case == "k_gt_valid":
        assert (got_i[:, 10:] == -1).all()
    for row_v, row_ok in zip(got_v, valid):
        assert (np.diff(row_v[row_ok]) <= 0).all()


@pytest.mark.parametrize("case", ["interior", "k_gt_valid"])
def test_b3_wrapper_matches_pq_score_chunk_xla(rng, case):
    """The wrapper's CPU route (plain B3, f32 q) against the JAX package's
    off-TPU IVF-PQ scorer on a bf16 chunk: identical ids, f32 scores
    within ATOL on the valid slots."""
    q, db, ids, bias = _masked_case(rng, 16, 1024, 32, 128, case)
    dec = torch.from_numpy(db).to(torch.bfloat16)
    want_v, want_i = _pq_score_chunk_xla(
        jnp.asarray(q), jnp.asarray(db).astype(jnp.bfloat16),
        jnp.asarray(ids), jnp.asarray(bias), k=20, lt=128)
    got_v, got_i = T.topk_ip_masked(torch.from_numpy(q), dec,
                                    torch.from_numpy(ids),
                                    torch.from_numpy(bias), 20, 128)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    valid = np.asarray(want_i) >= 0
    np.testing.assert_allclose(got_v.numpy()[valid],
                               np.asarray(want_v)[valid], rtol=0, atol=ATOL)


def test_b3_wrapper_rejects_bad_arguments():
    q = torch.zeros(2, 8)
    db = torch.zeros(256, 8, dtype=torch.bfloat16)
    ids = torch.arange(256, dtype=torch.int32)
    with pytest.raises(ValueError, match="k=129"):
        T.topk_ip_masked(q, db, ids, torch.zeros(2, 2), 129, 128)
    with pytest.raises(ValueError, match="list_tile=32"):
        T.topk_ip_masked(q, db, ids, torch.zeros(2, 8), 4, 32)
    with pytest.raises(ValueError, match="bias"):
        T.topk_ip_masked(q, db, ids, torch.zeros(2, 3), 4, 128)


@pytest.mark.gpu
def test_kernels_match_plain_on_gpu():
    """Each CUDA kernel against its plain version on the card, at the main
    path's widths; the launch counters count the kernel calls."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    T.reset_launches()
    for bq, n, k in [(128, 61_950, 20), (1, 5_000, 20), (7, 30, 50)]:
        q = torch.from_numpy(_rand(rng, (bq, 128))).to(dev)
        db = torch.from_numpy(_rand(rng, (n, 128))).to(dev)
        v, i = T.topk_ip(q, db, k)
        pv, pi = T.topk_ip_plain(q, db, k)
        sim = (q.double() @ db.double().T).cpu().numpy()
        _check_same(v.cpu(), i.cpu(), pv.cpu(), pi.cpu(), sim)
    x = _rand(rng, (8192, 128))
    q8, sc = _quantize(x)
    dead = rng.random(8192) < 0.05
    sc = np.where(dead, 0.0, sc).astype(np.float32)
    rmask = np.where(dead, NEG, 0.0).astype(np.float32)
    args = [torch.from_numpy(a).to(dev) for a in (q8, sc, rmask)]
    q = torch.from_numpy(_rand(rng, (256, 128))).to(dev)
    v, i = T.topk_ip_sq8(q, *args, 20)
    pv, pi = T.topk_ip_sq8_plain(q, *args, 20, compute_dtype=torch.bfloat16)
    qb = q.to(torch.bfloat16).double().cpu().numpy()
    sim = (qb @ q8.T.astype(np.float64)) * sc + rmask
    _check_same(v.cpu(), i.cpu(), pv.cpu(), pi.cpu(), sim)
    for bq, k, case in [(128, 20, "interior"), (1, 80, "unprobed_query"),
                        (5, 40, "k_gt_valid")]:
        qn, dbn, idn, bn = _masked_case(rng, bq, 16_384, 128, 128, case)
        args = [torch.from_numpy(a).to(dev) for a in (qn, dbn, idn, bn)]
        args[1] = args[1].to(torch.bfloat16)
        v, i = T.topk_ip_masked(*args, k, 128)
        pv, pi = T.topk_ip_masked_plain(*args, k, 128,
                                        compute_dtype=torch.bfloat16)
        # identical ids; bf16 products summed in f32 in another order
        np.testing.assert_array_equal(i.cpu().numpy(), pi.cpu().numpy())
        ok = pi >= 0
        np.testing.assert_allclose(v[ok].cpu().numpy(), pv[ok].cpu().numpy(),
                                   rtol=0, atol=ATOL)
    assert T.LAUNCHES == {"topk_ip": 3, "topk_ip_sq8": 1,
                          "topk_ip_masked": 3}
