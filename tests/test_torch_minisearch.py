"""Port parity: the in-training mini-search (nafp_tpu_torch.search.
minisearch) against the JAX package's on the same embeddings, on the CPU:
distances, conv-eye band sums, ranks (ties count against the ground
truth), top-1/3/10 and mean rank, including a collapsed model."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nafp_tpu.search import minisearch as J
from nafp_tpu_torch.search import minisearch as P

SCOPES = (1, 3, 5, 9, 11, 19)
# f32 products on both sides, sums in other orders
DIST_ATOL = 1e-5


def _noisy_set(seed, n_db=120, n_q=100, d=32, noise=1.2, offset=0):
    """Queries near db rows [offset, offset + n_q), noisy enough that
    ranks spread."""
    rng = np.random.default_rng(seed)
    db = rng.standard_normal((n_db, d)).astype(np.float32)
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    q = db[offset:offset + n_q, None, :] + noise * rng.standard_normal(
        (n_q, 1, d)).astype(np.float32) / np.sqrt(d)
    return q, db


@pytest.mark.parametrize("mode", ["argmin", "argmax"])
@pytest.mark.parametrize("offset", [0, 7])
def test_mini_search_eval_matches_jax(mode, offset):
    q, db = _noisy_set(offset + 1, offset=offset)
    (wt1, wt3, wt10), wrank = J.mini_search_eval(
        jnp.asarray(q), jnp.asarray(db), scopes=SCOPES, mode=mode,
        display=False, gt_id_offset=offset)
    (gt1, gt3, gt10), grank = P.mini_search_eval(
        torch.from_numpy(q), torch.from_numpy(db), scopes=SCOPES, mode=mode,
        display=False, gt_id_offset=offset)
    for g, w in ((gt1, wt1), (gt3, wt3), (gt10, wt10), (grank, wrank)):
        np.testing.assert_array_equal(g, w)
    assert 0 < wt1[0] < 100           # the set is neither trivial nor hopeless


def test_distances_and_ranks_match_jax():
    q, db = _noisy_set(3, n_db=40, n_q=30, d=16)
    q = np.concatenate([q, q[:, :1] * 0.5], axis=1)      # two augmentations
    for kw in ({}, {"squared": False}, {"return_dotprod": True}):
        w = np.asarray(J.pairwise_distances(jnp.asarray(q), jnp.asarray(db),
                                            **kw))
        g = P.pairwise_distances(torch.from_numpy(q), torch.from_numpy(db),
                                 **kw).numpy()
        np.testing.assert_allclose(g, w, atol=DIST_ATOL, rtol=0)
    all_d = J.pairwise_distances(jnp.asarray(q), jnp.asarray(db))
    for scope in (1, 3, 5):
        want = np.asarray(J._ranks_for_scope(all_d, scope, 1.0, 0))
        got = P._ranks_for_scope(torch.from_numpy(np.asarray(all_d)), scope,
                                 1.0, 0).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(
            P.conv_eye(torch.from_numpy(np.asarray(all_d)), scope).numpy(),
            np.asarray(J.conv_eye(all_d, scope)), rtol=1e-6)


def test_collapsed_embeddings_read_as_chance_in_both():
    q, db = np.ones((10, 1, 8), np.float32), np.ones((30, 8), np.float32)
    (w1, _, w10), wr = J.mini_search_eval(jnp.asarray(q), jnp.asarray(db),
                                          scopes=(1, 3), display=False)
    (g1, _, g10), gr = P.mini_search_eval(torch.from_numpy(q),
                                          torch.from_numpy(db), scopes=(1, 3),
                                          display=False)
    np.testing.assert_array_equal(g1, w1)
    np.testing.assert_array_equal(gr, wr)
    assert g1[0] == 0.0 and g10[0] == 0.0 and gr[0] == 29.0
