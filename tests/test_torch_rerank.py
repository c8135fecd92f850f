"""The ICASSP re-rank of a query block (``search/evaluate.py``):

- on the CPU, the port's plain route (``hits_for_block`` with the raw rows
  as a CPU tensor: ``candidate_starts`` + ``rerank_plain``) gives the JAX
  package's answers (``_hits_for_block`` with the rows as a device array:
  ``jax.lax.top_k``) from the same segment hits: tail ids with n_seg < sl,
  no hits at all, repeated starts, windows past the DB's end, exact score
  ties, sl 1 and 19, B 1 and 128. The rows and queries are small integers,
  so every score is exact in f32 in both packages and the answers must be
  equal, ties included;
- the block assembly and the plain route's input checks;
- marked ``gpu``, on the card: the kernel ``rerank_f32`` against the plain
  version at every length of the protocol's traffic (B 128, k 20 over
  619,500 rows of d 128), at a sl·k past the kernel's shared-memory budget,
  and on integer data where both must be equal. Ids may differ only at f32
  near-ties, and the float64 score of each answer lies within 1e-6 of the
  plain one's.
"""
import numpy as np
import pytest
import torch

from nafp_tpu_torch.search import evaluate as E

CPU = torch.device("cpu")


class _Hits:
    """An index whose search returns the segment hits it was given."""

    def __init__(self, hits):
        self.hits = hits

    def search(self, q, k):
        assert q.shape[0] == self.hits.shape[0] * self.hits.shape[1]
        return None, self.hits.reshape(-1, k)


def _case(case, b, sl, k, seed=0):
    """Integer rows (N, 16), queries, test ids and (B, sl, k) int32 hits."""
    rng = np.random.default_rng(seed)
    n, d = 600, 16
    recon = rng.integers(-3, 4, (n, d)).astype(np.float32)
    if case == "ties":             # rows 300.. repeat rows 100.. exactly
        recon[300:300 + 40] = recon[100:140]
    query = rng.integers(-3, 4, (b + sl + 40, d)).astype(np.float32)
    ids = np.sort(rng.choice(len(query) - sl, b, replace=False))
    hits = rng.integers(-1, n, (b, sl, k)).astype(np.int32)
    if case == "tail":              # the last ids have fewer than sl left
        ids[-min(b, sl):] = len(query) - 1 - np.arange(min(b, sl))[::-1]
        ids = np.unique(ids)
        hits = hits[:len(ids)]
    elif case == "no_hits":
        hits[:] = -1
    elif case == "duplicates":      # hit - j repeats the same start
        start = rng.integers(0, n - sl, (b, 1, 1))
        hits[:, :, :k // 2] = start + np.arange(sl)[None, :, None]
    elif case == "past_end":        # windows that run past the DB
        hits[:, :, :k // 2] = rng.integers(n - sl, n, (b, sl, k // 2))
    elif case == "ties":            # twin windows at 100.. and 300..
        hits[:, :, 0] = rng.integers(100, 120, (b, sl))
        hits[:, :, 1] = hits[:, :, 0] + 200
    return recon, query, ids, hits


CASES = [("plain", 1, 1, 20), ("plain", 128, 1, 20), ("plain", 1, 19, 20),
         ("plain", 128, 19, 20), ("plain", 4, 1, 5), ("tail", 16, 5, 10),
         ("tail", 128, 19, 20), ("no_hits", 4, 3, 5),
         ("duplicates", 8, 5, 10), ("past_end", 8, 5, 10),
         ("ties", 8, 3, 10), ("ties", 128, 19, 20)]


@pytest.mark.parametrize("case,b,sl,k", CASES,
                         ids=[f"{c}-b{b}-sl{sl}-k{k}" for c, b, sl, k in CASES])
def test_plain_route_matches_jax(case, b, sl, k):
    import jax.numpy as jnp
    from nafp_tpu.search import evaluate as JE
    recon, query, ids, hits = _case(case, b, sl, k)
    idx = _Hits(hits)
    got = E.hits_for_block(idx, torch.from_numpy(recon), recon, query, ids,
                           sl, k)
    want = JE._hits_for_block(idx, jnp.asarray(recon), recon, query, ids,
                              sl, k)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert got.shape == (len(ids), min(10, sl * k))
    if case == "no_hits":
        assert (got == E.NO_PICK).all()
    if case == "ties":              # a twin pair ties: the lower start wins
        assert (got != E.NO_PICK).all()
    # the host route gives the same answers
    host = E.hits_for_block(idx, None, recon, query, ids, sl, k)
    np.testing.assert_array_equal(host, got)


def test_fill_queries_is_the_per_clip_loop(rng):
    """The block's query rows, zero past each clip's n_seg, as the
    per-clip loop of the JAX package fills them."""
    query = rng.standard_normal((50, 8)).astype(np.float32)
    ids = np.array([0, 7, 30, 45, 47, 49])
    sl = 5
    q_seq = np.full((len(ids), sl, 8), np.nan, np.float32)
    n_seg = np.full(len(ids), -7, np.int32)
    E._fill_queries(query, ids, sl, q_seq, n_seg)
    want = np.zeros_like(q_seq)
    want_n = np.minimum(len(query) - ids, sl)
    for j, t in enumerate(ids):
        want[j, :want_n[j]] = query[t:t + want_n[j]]
    np.testing.assert_array_equal(n_seg, want_n)
    np.testing.assert_array_equal(q_seq, want)


def test_candidate_starts():
    hits = np.array([[[5, -1], [9, 2], [7, 7]]], np.int32)   # B 1, sl 3
    got = E.candidate_starts(hits, np.array([2], np.int32), 3)
    # segment 2 is padding; 2 - 1 = 1 stays, -1 stays -1
    np.testing.assert_array_equal(got, [[5, -1, 8, 1, -1, -1]])


def test_staging_views_share_one_buffer():
    """The card route's staging: q_seq, hits and n_seg at 16-byte
    boundaries of one buffer, and the views of its copy match them."""
    s = E._Staging.__new__(E._Staging)      # an unpinned buffer on the CPU
    s.parts, size = E._Staging.layout(3, 5, 6, 7)
    s.buf = torch.zeros(size, dtype=torch.uint8)
    q, h, n = (t.numpy() for t in s.views(s.buf))
    q[...] = np.arange(90).reshape(3, 5, 6)
    h[...] = -np.arange(105).reshape(3, 5, 7)
    n[...] = [1, 2, 3]
    tq, th, tn = s.views(s.buf.clone())
    assert [p[0] % 16 for p in s.parts] == [0, 0, 0]
    np.testing.assert_array_equal(tq.numpy(), q)
    np.testing.assert_array_equal(th.numpy(), h)
    np.testing.assert_array_equal(tn.numpy(), [1, 2, 3])
    assert tq.dtype == torch.float32 and th.dtype == tn.dtype == torch.int32


def test_kernel_wrapper_refuses_cpu_tensors():
    q = torch.zeros(2, 3, 4)
    hits = torch.zeros(2, 3, 5, dtype=torch.int32)
    n_seg = torch.full((2,), 3, dtype=torch.int32)
    with pytest.raises(ValueError, match="plain version is rerank_plain"):
        E.rerank_f32(q, hits, n_seg, torch.zeros(10, 4), 10)


# -- on the card ---------------------------------------------------------------
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")
    return torch.device("cuda", 0)


def _cell_case(dev, b, sl, k, n, d, seed):
    """Unit rows on the card, queries near a planted window of each clip,
    and hits: the planted start + j, repeats, misses and random rows."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    recon = torch.randn((n, d), generator=gen, device=dev)
    recon /= torch.linalg.vector_norm(recon, dim=1, keepdim=True)
    n_seg = torch.full((b,), sl, dtype=torch.int32, device=dev)
    n_seg[-min(b, 3):] = torch.tensor([1, max(1, sl // 2), sl],
                                      dtype=torch.int32, device=dev)[-min(b, 3):]
    start = torch.randint(0, n - sl, (b,), generator=gen, device=dev)
    off = torch.arange(sl, device=dev)
    q = recon[start[:, None] + off] + 0.05 * torch.randn(
        (b, sl, d), generator=gen, device=dev)
    q *= (off[None, :] < n_seg[:, None])[:, :, None]
    hits = torch.randint(-1, n, (b, sl, k), generator=gen, device=dev,
                         dtype=torch.int32)
    hits[:, :, 0] = (start[:, None] + off).int()
    hits[:, :, 1] = hits[:, :, 0]                         # repeats
    if k > 2:
        hits[:, :, 2] = n - 1                             # past the end
    return q.contiguous(), hits, n_seg, recon


def _plain(q, hits, n_seg, recon):
    b, sl, k = hits.shape
    cands = E.candidate_starts(hits.cpu().numpy(), n_seg.cpu().numpy(), sl)
    return E.rerank_plain(q, torch.from_numpy(cands).to(recon.device), recon,
                          sl, n_seg)


def _scores64(q, n_seg, recon, picks):
    """float64 sequence scores of picks (B, K); -inf at NO_PICK."""
    sl = q.shape[1]
    p = picks.long()
    win = (p.clamp(min=0)[:, :, None] + torch.arange(sl, device=p.device)
           ).clamp(max=recon.shape[0] - 1)
    s = torch.einsum("bsd,bksd->bk", q.double(), recon.double()[win]) \
        / n_seg[:, None].double()
    return torch.where(p == E.NO_PICK, -torch.inf, s)


def _check_against_plain(q, hits, n_seg, recon, tag):
    got = E.rerank_f32(q, hits, n_seg, recon, min(10, hits.shape[1]
                                                  * hits.shape[2]))
    want = _plain(q, hits, n_seg, recon)
    torch.cuda.synchronize()
    assert got.shape == want.shape, tag
    gs, ws = _scores64(q, n_seg, recon, got), _scores64(q, n_seg, recon, want)
    assert torch.equal(got == E.NO_PICK, want == E.NO_PICK), tag
    fin = torch.isfinite(ws)
    gap = float((gs - ws)[fin].abs().max()) if fin.any() else 0.0
    assert gap <= 1e-6, (tag, gap)
    # ids equal wherever the plain scores are clear of their neighbours
    pad = torch.full_like(ws[:, :1], -torch.inf)
    clear = torch.minimum(
        torch.cat([torch.full_like(pad, torch.inf), ws[:, :-1]], 1) - ws,
        ws - torch.cat([ws[:, 1:], pad], 1)) > 2e-6
    assert torch.equal(got.long()[clear], want[clear]), tag
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("sl", [1, 3, 5, 9, 11, 19])
def test_kernel_matches_plain_at_the_traffic_lengths(sl):
    dev = _card()
    q, hits, n_seg, recon = _cell_case(dev, 128, sl, 20, 619_500, 128, sl)
    E.reset_launches()
    got = _check_against_plain(q, hits, n_seg, recon, f"sl {sl}")
    assert E.LAUNCHES["rerank"] == 1
    # the planted window wins wherever its clip has every segment
    full = n_seg == sl
    assert torch.equal(got[full, 0], hits[full, 0, 0]), sl


@pytest.mark.gpu
@pytest.mark.parametrize("b,sl,k,d", [(4, 70, 128, 32), (3, 9, 100, 18),
                                      (1, 2, 3, 128)])
def test_kernel_past_its_shared_memory_and_odd_shapes(b, sl, k, d):
    """sl·k 8,960 sorts in the wrapper's scratch; d 18 takes the
    one-float lanes; sl·k 6 gives 6 answers."""
    dev = _card()
    q, hits, n_seg, recon = _cell_case(dev, b, sl, k, 50_000, d, 7)
    _check_against_plain(q, hits, n_seg, recon, f"{b} {sl} {k} {d}")


@pytest.mark.gpu
@pytest.mark.parametrize("case,b,sl,k", CASES,
                         ids=[f"{c}-b{b}-sl{sl}-k{k}" for c, b, sl, k in CASES])
def test_kernel_equals_plain_on_exact_scores(case, b, sl, k):
    """Integer data: every score is exact, so the answers are equal, ties
    to the lower start included."""
    dev = _card()
    recon, query, ids, hits = _case(case, b, sl, k)
    q_seq = np.empty((len(ids), sl, recon.shape[1]), np.float32)
    n_seg = np.empty(len(ids), np.int32)
    E._fill_queries(query, ids, sl, q_seq, n_seg)
    args = [torch.from_numpy(a).to(dev) for a in (q_seq, hits, n_seg, recon)]
    got = E.rerank_f32(*args, min(10, sl * k))
    want = _plain(*args)
    assert torch.equal(got.long(), want), case
