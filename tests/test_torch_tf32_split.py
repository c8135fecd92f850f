"""Kernel B1's numerics on the CPU: the 3xTF32 split of
``csrc/mma_tile.cuh`` (``cvt.rna.tf32.f32`` emulated in numpy) keeps the
f32 reference's score tolerance on seeded standard-normal rows, the gpu
test's data, where one TF32 pass does not. The kernel itself runs only on
the card (tests/test_torch_topk.py, marked ``gpu``)."""
import numpy as np
import pytest

ATOL = 1e-4   # scores, as tests/test_torch_topk.py holds kernel B1


def rna_tf32(x):
    """x (f32) rounded to TF32 (10 explicit significand bits), to nearest
    with ties away from zero, as ``cvt.rna.tf32.f32``: half an ulp of the
    13 dropped bits added to the magnitude, then the bits cut."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def split(x):
    hi = rna_tf32(x)
    return hi, rna_tf32(x - hi)


def tf32_scores(q, db, passes):
    """q . db^T as the kernel sums it: a partial sum per k8 step, in f32,
    of a_lo.b_hi + a_hi.b_lo + a_hi.b_hi (passes 3) or a_hi.b_hi alone
    (passes 1), added to the running f32 sum."""
    (qh, ql), (bh, bl) = split(q), split(db)
    terms = [(ql, bh), (qh, bl), (qh, bh)] if passes == 3 else [(qh, bh)]
    acc = np.zeros((q.shape[0], db.shape[0]), np.float32)
    for k0 in range(0, q.shape[1], 8):
        part = np.zeros_like(acc)
        for a, b in terms:
            part += a[:, k0:k0 + 8] @ b[:, k0:k0 + 8].T
        acc += part
    return acc


def test_rounding_is_nearest_ties_away():
    ulp = 2.0 ** -10    # TF32's ulp at 1
    x = np.array([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2.0 ** -23,
                  1 + 1.5 * ulp, 3.0], np.float32)
    np.testing.assert_array_equal(
        rna_tf32(x), np.array([1 + ulp, -(1 + ulp), 1, 1 + 2 * ulp, 3.0],
                              np.float32))
    v = np.random.default_rng(0).standard_normal(10_000).astype(np.float32)
    hi, lo = split(v)
    # hi and lo are TF32 values; x - hi is exact, and lo keeps it to 2^-22
    assert ((hi.view(np.uint32) | lo.view(np.uint32)) & 0x1FFF == 0).all()
    np.testing.assert_array_equal(v - hi, (v.astype(np.float64) - hi))
    assert (np.abs(v.astype(np.float64) - hi - lo)
            <= 2.0 ** -22 * np.abs(v)).all()


@pytest.mark.parametrize("d", [128, 256])
def test_3xtf32_keeps_the_f32_tolerance(d):
    """Max |error| against f64 on 64 x 4,096 seeded rows: 3xTF32 within
    ATOL and near the f32 product's own error; one TF32 pass far above."""
    rng = np.random.default_rng(d)
    q = rng.standard_normal((64, d)).astype(np.float32)
    db = rng.standard_normal((4096, d)).astype(np.float32)
    exact = q.astype(np.float64) @ db.T.astype(np.float64)
    err3 = np.abs(tf32_scores(q, db, 3) - exact).max()
    err1 = np.abs(tf32_scores(q, db, 1) - exact).max()
    err32 = np.abs((q @ db.T) - exact).max()
    assert err3 <= ATOL, err3
    assert err3 <= 3 * err32, (err3, err32)
    assert err1 > 10 * ATOL, err1
