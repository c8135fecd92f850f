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


@pytest.mark.parametrize("bq,n,k,tomb,d,negative", [
    pytest.param(8, 4096, 20, 0.0, 128, False, id="8-4096-20-0.0"),
    # tombstones inside the store
    pytest.param(8, 2048, 16, 0.05, 128, False, id="8-2048-16-0.05"),
    # more masked rows than k: ids -1 past the valid
    pytest.param(3, 2048, 20, 0.995, 128, False, id="3-2048-20-0.995"),
    # the kernel's larger k, its second K extent (d 256) and its narrow row
    # copies (d 20); every real score negative
    (8, 2048, 80, 0.05, 256, False),
    (4, 2048, 128, 0.05, 20, True),
    (3, 2048, 128, 0.995, 20, False),
    (5, 2048, 80, 0.995, 256, True),
])
def test_b2_plain_matches_pallas(rng, bq, n, k, tomb, d, negative):
    x = _rand(rng, (n, d))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    if negative:   # positive rows, negative queries
        x = np.abs(x)
    q8, sc = _quantize(x)
    dead = rng.random(n) < tomb
    if tomb > 0.9:
        dead[:] = True
        dead[rng.choice(n, 5, replace=False)] = False
    sc = np.where(dead, 0.0, sc).astype(np.float32)
    rmask = np.where(dead, NEG, 0.0).astype(np.float32)
    q = _rand(rng, (bq, d))
    if negative:
        q = -np.abs(q)
    want_v, want_i = topk_ip_sq8_pallas(
        jnp.asarray(q), jnp.asarray(q8), jnp.asarray(sc), jnp.asarray(rmask),
        k=k, blk=1024, interpret=True)
    got_v, got_i = T.topk_ip_sq8(torch.from_numpy(q), torch.from_numpy(q8),
                                 torch.from_numpy(sc),
                                 torch.from_numpy(rmask), k)
    sim = (q.astype(np.float64) @ q8.T.astype(np.float64)) * sc + rmask
    _check_same(got_v, got_i, want_v, want_i, sim)
    got_i = got_i.numpy()
    assert not dead[got_i[got_i >= 0]].any()
    n_valid = min(k, int((~dead).sum()))
    assert (got_i[:, :n_valid] >= 0).all() and (got_i[:, n_valid:] == -1).all()
    if negative:
        assert (got_v.numpy()[:, :n_valid] < 0).all()


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


def test_scans_refuse_rows_past_int32_chunk_ends():
    """Row numbers and chunk ends are int32 in csrc/: a launch past
    MAX_ROWS rows raises before it plans a grid (checked before any card
    query, so it runs here)."""
    with pytest.raises(ValueError, match="at most"):
        T._launch(None, {}, "topk_ip", torch.zeros(1, 128),
                  [], T.MAX_ROWS + 1, 20, 1)
    # the last chunk's end: below N + N / 2 + RB with two chunks or more,
    # below N + RB with one
    assert T.MAX_ROWS + T.MAX_ROWS // 2 + T.RB < 2 ** 31


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


@pytest.mark.parametrize("d,ok", [(4, True), (20, True), (128, True),
                                  (256, True), (0, False), (6, False),
                                  (260, False)])
def test_card_row_width_rule(d, ok):
    """Every kernel of the port takes any d that is a multiple of 4 up to
    MAX_D on the card, the JAX kernels' range (int8 queries of B4a: a
    multiple of 16)."""
    if ok:
        T._check_d(d)
    else:
        with pytest.raises(ValueError, match=f"d={d}"):
            T._check_d(d)
    with pytest.raises(ValueError, match="d % 16"):
        T._check_d(20, 16)


# B1's wgmma scan on the card: query blocks around its 64-query CTA (32 at
# d 256) and the protocol's block sizes; N below k, N not a multiple of the
# 64-row tile, N past one chunk; d 4, 36, 128, 256; k 1, 20, 80, 128; rows
# repeated across chunks (the lower twin wins each tie); every score
# negative; half the queries zero (a padded block: every row ties, the
# lowest rows win). Standard-normal rows: scores up to ~50-80, where one
# TF32 pass or bf16x3 would miss ATOL.
B1_GPU_CASES = [
    # bq, n, d, k, case
    (1, 5_000, 128, 20, ""),
    (63, 70_000, 128, 20, ""),
    (64, 70_000, 4, 1, ""),
    (65, 70_000, 128, 80, ""),
    (128, 619_500, 128, 20, ""),
    (384, 619_500, 128, 20, ""),
    (512, 619_500, 128, 128, ""),
    (512, 619_500, 128, 20, "negative"),
    (7, 50, 128, 80, ""),
    (33, 1_000, 36, 20, ""),
    (128, 65_536, 128, 20, "twins"),
    (200, 65_536, 256, 80, "twins"),
    (512, 70_001, 128, 128, "negative"),
    (65, 3, 256, 1, ""),
    (512, 70_000, 128, 20, "zeros"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("bq,n,d,k,case", B1_GPU_CASES)
def test_b1_scan_matches_plain_on_gpu(bq, n, d, k, case):
    """B1 (3xTF32 on wgmma) against its plain version on the card: -1 at
    the same slots, scores within ATOL, the float64 scores at the kernel's
    ids equal to the plain scores within ATOL, sorted, one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(bq * 7 + n + d + k)
    qn, dbn = _rand(rng, (bq, d)), _rand(rng, (n, d))
    if case == "negative":
        qn, dbn = -np.abs(qn), np.abs(dbn)
    if case == "twins":
        dbn[n // 2:] = dbn[:n // 2]
    if case == "zeros":
        qn[bq // 2:] = 0.0
    q, db = torch.from_numpy(qn).to(dev), torch.from_numpy(dbn).to(dev)
    T.reset_launches()
    v, i = T.topk_ip(q, db, k)
    assert T.LAUNCHES["topk_ip"] == 1
    pv, pi = T.topk_ip_plain(q, db, k)
    ok = pi >= 0
    assert torch.equal(i < 0, pi < 0)
    assert int(ok.sum(1).min()) == min(k, n)
    assert float((v - pv).abs()[ok].max()) <= ATOL
    at = torch.einsum("bd,bkd->bk", q.double(),
                      db.double()[i.clamp(min=0).long()])
    assert float((at - pv.double()).abs()[ok].max()) <= ATOL
    vv = torch.where(ok, v, float("-inf"))
    assert bool((vv[:, :-1] >= vv[:, 1:]).all())
    got = i.cpu().numpy()
    assert ((got[:, :min(k, n)] >= 0) & (got[:, :min(k, n)] < n)).all()
    if case == "negative":
        assert (v.cpu().numpy()[:, :min(k, n)] < 0).all()
    if case == "twins":   # the lower twin wins: with a row, its twin
        for row in got:
            assert np.isin(row[row >= n // 2] - n // 2, row).all()
    if case == "zeros":
        assert (got[bq // 2:] == np.arange(k)).all()
        assert (v.cpu().numpy()[bq // 2:] == 0).all()


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
    # B1 (3xTF32 on the tensor cores; standard-normal rows: scores up to
    # ~50, where bf16x3 or one TF32 pass would miss ATOL): k 20 / 80 / 128
    # at the main shape, a ragged query block, every score negative, k > N,
    # rows 32,768 apart repeating each other (other chunks), d 256 and d 20
    for bq, n, k, d, case in [(128, 61_950, 20, 128, ""),
                              (1, 5_000, 20, 128, ""), (7, 30, 50, 128, ""),
                              (512, 619_500, 80, 128, ""),
                              (512, 619_500, 128, 128, ""),
                              (300, 61_950, 80, 128, ""),
                              (512, 619_500, 80, 128, "negative"),
                              (128, 65_536, 80, 128, "twins"),
                              (200, 65_536, 80, 256, ""),
                              (64, 65_536, 128, 20, "")]:
        qn, dbn = _rand(rng, (bq, d)), _rand(rng, (n, d))
        if case == "negative":
            qn, dbn = -np.abs(qn), np.abs(dbn)
        if case == "twins":
            dbn[n // 2:] = dbn[:n // 2]
        q, db = torch.from_numpy(qn).to(dev), torch.from_numpy(dbn).to(dev)
        v, i = T.topk_ip(q, db, k)
        pv, pi = T.topk_ip_plain(q, db, k)
        sim = (q.double() @ db.double().T).cpu().numpy()
        _check_same(v.cpu(), i.cpu(), pv.cpu(), pi.cpu(), sim)
        got = i.cpu().numpy()
        assert (np.diff(v.cpu().numpy()[:, :min(k, n)], axis=1) <= 0).all()
        if case == "negative":
            assert (v.cpu().numpy() < 0).all() and (got >= 0).all()
        if case == "twins":   # the lower twin wins: with a row, its twin
            for row in got:
                assert np.isin(row[row >= n // 2] - n // 2, row).all()
        del sim
    # B2, the sq8 scan on the tensor cores: 5 % tombstones at k 20 / 80 /
    # 128, every real score negative, k > valid rows (5 of 2048), d 256
    # and d 20, and rows 4,096 apart repeating each other (other chunks)
    for bq, n, k, d, case in [(256, 8192, 20, 128, "tombstones"),
                              (200, 8192, 80, 128, "tombstones"),
                              (64, 8192, 128, 128, "tombstones"),
                              (100, 8192, 80, 256, "negative"),
                              (33, 8192, 128, 20, "tombstones"),
                              (7, 2048, 48, 128, "few_valid"),
                              (128, 8192, 80, 128, "twins")]:
        x = _rand(rng, (n, d))
        if case == "negative":
            x = np.abs(x)
        if case == "twins":
            x[n // 2:] = x[:n // 2]
        q8, sc = _quantize(x)
        dead = rng.random(n) < (0.0 if case == "twins" else 0.05)
        if case == "few_valid":
            dead[:] = True
            dead[rng.choice(n, 5, replace=False)] = False
        sc = np.where(dead, 0.0, sc).astype(np.float32)
        rmask = np.where(dead, NEG, 0.0).astype(np.float32)
        args = [torch.from_numpy(a).to(dev) for a in (q8, sc, rmask)]
        qn = _rand(rng, (bq, d))
        if case == "negative":
            qn = -np.abs(qn)
        q = torch.from_numpy(qn).to(dev)
        v, i = T.topk_ip_sq8(q, *args, k)
        pv, pi = T.topk_ip_sq8_plain(q, *args, k,
                                     compute_dtype=torch.bfloat16)
        # bf16 products summed in f32 in the tensor cores' order: ids equal
        # but at near-ties, where the f64 scores at the kernel's ids equal
        # the plain scores within ATOL
        qb = q.to(torch.bfloat16).double().cpu().numpy()
        sim = (qb @ q8.T.astype(np.float64)) * sc + rmask
        _check_same(v.cpu(), i.cpu(), pv.cpu(), pi.cpu(), sim)
        got = i.cpu().numpy()
        assert not dead[got[got >= 0]].any()
        if case == "negative":
            assert (v.cpu().numpy() < 0).all() and (got >= 0).all()
        if case == "few_valid":
            assert (got[:, :5] >= 0).all() and (got[:, 5:] == -1).all()
        if case == "twins":   # the lower twin wins: with a row, its twin
            for row in got:
                assert np.isin(row[row >= n // 2] - n // 2, row).all()
    # d 256: the kernel's second K extent; d 20: 8-byte row copies
    for bq, k, case, d in [(128, 20, "interior", 128),
                           (1, 80, "unprobed_query", 128),
                           (5, 40, "k_gt_valid", 128),
                           (128, 80, "interior", 128), (200, 80, "ties", 128),
                           (64, 33, "ties", 128), (200, 80, "interior", 256),
                           (64, 20, "interior", 20)]:
        qn, dbn, idn, bn = _masked_case(rng, bq, 16_384, d, 128, case)
        if case == "ties":
            # rows 8,192 apart repeat each other (other chunks), all valid
            # and probed: equal scores meet the shared bound, and the
            # lower row must win each tie
            dbn[8192:] = dbn[:8192]
            idn = np.arange(16_384, dtype=np.int32)
            bn[:] = 0.0
        args = [torch.from_numpy(a).to(dev) for a in (qn, dbn, idn, bn)]
        args[1] = args[1].to(torch.bfloat16)
        v, i = T.topk_ip_masked(*args, k, 128)
        pv, pi = T.topk_ip_masked_plain(*args, k, 128,
                                        compute_dtype=torch.bfloat16)
        # bf16 products summed in f32 in another order (the tensor cores'):
        # ids equal but at near-ties, where the f64 scores at the kernel's
        # ids equal the plain scores within ATOL (as chip_smoke.py judges)
        qb = args[0].to(torch.bfloat16).double().cpu().numpy()
        sim = (qb @ args[1].double().cpu().numpy().T
               + np.repeat(bn, 128, axis=1))
        sim_id = np.full((bq, 16_384), NEG)          # by row id
        sim_id[:, idn[idn >= 0]] = sim[:, idn >= 0]
        _check_same(v.cpu(), i.cpu(), pv.cpu(), pi.cpu(), sim_id)
        if case == "ties":   # the lower twin wins: with a row, its twin
            got = i.cpu().numpy()
            for row in got:
                assert np.isin(row[row >= 8192] - 8192, row).all()
    assert T.LAUNCHES == {"topk_ip": 10, "topk_ip_sq8": 7,
                          "topk_ip_masked": 8}
