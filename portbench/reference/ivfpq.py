"""Plain IVF-PQ search and encoding in float64, judged by score gaps.

IVF-PQ as the reference sets it up (``eval/get_index_faiss.py:69-74,120``,
after Jégou et al., "Product quantization for nearest neighbor search",
TPAMI 2011): a coarse quantizer of ``nlist`` centroids, each row stored
as its nearest list (L2) and, per subspace of ``d / m`` dimensions, the
nearest of ``ksub`` codewords to its residual from that list's centroid.
A query probes the ``nprobe`` lists of highest ``q · centroid`` (ties to
the lower list) and ranks the rows stored in them by the asymmetric
distance computation, here the inner product
``adc(q, x) = q · c_list(x) + Σ_m q_m · B_m[code_m(x)]``.

Everything works from the trained state the port built (centroids,
codebooks, and each row's list and codes read off the padded store), as
float64: the f32 values are exact in it, and TF32 (which the runner's
check switches off first, ``reference/encoder.py::no_tf32``) never
touches a float64 product. Departures from the published
description, each for the check's sake:

- ``adc`` is computed as ``q · decode(x)``, ``decode(x) = c_list +
  concat_m B_m[code_m]``: the same sum regrouped, which float64 holds to
  ~1e-16, instead of through per-query lookup tables;
- the probe is judged with the f32 rounding the port's ``q · centroid``
  may carry (``probe_sets``): a list counts as certainly probed, or as
  possibly probed, by bounds on that rounding, so a near-tie at the
  ``nprobe``-th list is no fault;
- the encoding is judged given the stored list where that list's
  distance lies within the f32 rounding of the nearest's (``code_gap``).

A search answer is judged by how far the float64 ADC score of its j-th
best returned row lies below the reference's j-th best ADC score over
the certainly probed lists (``pq_gap``); a probe by whether it holds
every certainly probed list and no list that cannot be probed
(``probe_miss``); a store by how far each sampled row's squared distance
to its stored reconstruction lies above the distance to the
reconstruction the reference's own encoding gives (``code_gap``); and
the build, whose k-means the reference does not rerun (its seeding is
the port's own), by how far its centroids and codebooks lie from a
fixed point of Lloyd's iteration over the rows they were trained on
(``lloyd_gap``): a build that stopped early, or trained its books on
other rows than the residuals, lies farther from one.
"""
from __future__ import annotations

from typing import Tuple

import torch

BLOCK = 256          # query rows per float64 product block
ROWS = 65536         # training rows per float64 assignment block
U32 = 2.0 ** -24     # unit roundoff of float32


def gamma(n: int) -> float:
    """Bound on the relative error of an n-term f32 sum of products, in
    any order (Higham, Accuracy and Stability, §3.1)."""
    return n * U32 / (1.0 - n * U32)


def rows_of_store(codes: torch.Tensor, ids: torch.Tensor,
                  sub_list: torch.Tensor, list_tile: int, n: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each original row's list (n,) and codes (n, m), both int64, read
    off the padded store: ``codes`` (n_pad, m), ``ids`` (n_pad,) the
    original id of each slot (-1 for a pad), ``sub_list`` (n_pad /
    list_tile,) the list of each subtile. Raises if a row is stored twice
    or not at all."""
    real = ids >= 0
    pos = torch.nonzero(real).squeeze(1)
    rid = ids[real].long()
    if len(rid) != n or not torch.equal(
            torch.sort(rid).values, torch.arange(n, device=rid.device)):
        raise ValueError("the store does not hold each row exactly once")
    lists = torch.empty(n, dtype=torch.int64, device=ids.device)
    lists[rid] = sub_list.long()[pos // list_tile]
    out = torch.empty((n, codes.shape[1]), dtype=torch.int64,
                      device=ids.device)
    out[rid] = codes[pos].long()
    return lists, out


def decode(centroids: torch.Tensor, books: torch.Tensor,
           lists: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """(n, d) float64 ``c_list + concat_m books[m, code_m]``."""
    m, _, dsub = books.shape
    sel = books.double()[torch.arange(m, device=codes.device), codes]
    return centroids.double()[lists] + sel.reshape(len(codes), m * dsub)


def probe_sets(q: torch.Tensor, centroids: torch.Tensor, nprobe: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(b, nlist) bools: the lists certainly among the ``nprobe`` a probe
    computed in f32 picks, and those possibly among them.

    The f32 score of list c lies within ``e_c = gamma(d) · Σ|q_i||c_i|``
    of the float64 ``s_c``. List c is certainly picked when fewer than
    ``nprobe`` other lists could score at least as high (``s_c' + e_c' >=
    s_c - e_c``), and possibly picked unless ``nprobe`` lists certainly
    score higher (``s_c' - e_c' > s_c + e_c``). With no near-tie both are
    the float64 top ``nprobe``."""
    q64, c64 = q.double(), centroids.double()
    s = q64 @ c64.T
    e = gamma(q.shape[1]) * (q64.abs() @ c64.abs().T)
    lo, hi = (s - e)[:, :, None], (s + e)[:, :, None]
    eye = torch.eye(s.shape[1], dtype=torch.bool, device=s.device)
    may_beat = (hi.transpose(1, 2) >= lo) & ~eye      # [b, c, c']
    beats = lo.transpose(1, 2) > hi
    return may_beat.sum(2) < nprobe, beats.sum(2) < nprobe


def probe_miss(q: torch.Tensor, centroids: torch.Tensor, nprobe: int,
               probed: torch.Tensor) -> float:
    """Share of the rows of ``q`` (nq, d) whose probed lists (``probed``,
    (nq, nlist) bools: the port's probe) leave out a list certainly among
    the ``nprobe`` best or take one that cannot be among them."""
    miss = 0
    for s in range(0, len(q), BLOCK):
        certain, possible = probe_sets(q[s:s + BLOCK], centroids, nprobe)
        got = probed[s:s + BLOCK].to(certain.device)
        miss += int(((certain & ~got) | (got & ~possible)).any(1).sum())
    return miss / max(len(q), 1)


def _lloyd_terms(x: torch.Tensor, cents: torch.Tensor
                 ) -> Tuple[float, float]:
    """In float64, with each row of ``x`` (n, d) assigned to its nearest
    row of ``cents`` (k, d) and ``mu_c`` the mean of the n_c rows assigned
    to c: ``Σ_c n_c |mu_c − c|²``, what the next Lloyd update removes from
    the k-means objective, and the objective ``Σ_i min_c |x_i − c|²``."""
    c64 = cents.double()
    k, d = c64.shape
    sums = torch.zeros((k, d), dtype=torch.float64, device=x.device)
    n_c = torch.zeros(k, dtype=torch.float64, device=x.device)
    c_sq = (c64 ** 2).sum(1)
    obj = 0.0
    for s in range(0, len(x), ROWS):
        xb = x[s:s + ROWS].double()
        dist, a = ((xb ** 2).sum(1, keepdim=True) - 2 * xb @ c64.T
                   + c_sq[None]).min(1)
        obj += float(dist.clamp(min=0).sum())
        sums.index_add_(0, a, xb)
        n_c.index_add_(0, a, torch.ones_like(dist))
    mu = sums / n_c.clamp(min=1)[:, None]
    return float((n_c * ((mu - c64) ** 2).sum(1)).sum()), obj


def lloyd_gap(x: torch.Tensor, cents: torch.Tensor) -> float:
    """How far ``cents`` (k, d) lies from a fixed point of Lloyd's
    iteration over the rows ``x`` (n, d): the share of the k-means
    objective that the next update step removes (0 at a fixed point)."""
    moved, obj = _lloyd_terms(x, cents)
    return moved / max(obj, 1e-300)


def books_lloyd_gap(x: torch.Tensor, centroids: torch.Tensor,
                    books: torch.Tensor, lists: torch.Tensor) -> float:
    """``lloyd_gap`` of the codebooks ``books`` (m, ksub, dsub) over the
    residuals of the rows ``x`` from their stored lists' centroids,
    summed over the m subspaces: the update each book's next step makes,
    over the objective of all of them."""
    m, _, dsub = books.shape
    c64 = centroids.double()[lists]
    terms = [_lloyd_terms(x[:, mi * dsub:(mi + 1) * dsub].double()
                          - c64[:, mi * dsub:(mi + 1) * dsub], books[mi])
             for mi in range(m)]
    return sum(t[0] for t in terms) / max(sum(t[1] for t in terms), 1e-300)


def pq_gap(q: torch.Tensor, centroids: torch.Tensor, recon: torch.Tensor,
           lists: torch.Tensor, nprobe: int, ids) -> float:
    """Largest gap over the rows of ``q`` (nq, d) between the reference's
    j-th best ADC score over the certainly probed lists and the ADC score
    of the j-th best of ``ids`` (nq, k), the port's answer. A missing or
    repeated id, or one whose list is not possibly probed, counts as
    -inf; where the reference has fewer than j rows and the answer none,
    the gap is 0."""
    n = recon.shape[0]
    worst = 0.0
    for s in range(0, len(q), BLOCK):
        qb = q[s:s + BLOCK]
        certain, possible = probe_sets(qb, centroids, nprobe)
        score = qb.double() @ recon.T                         # (b, n)
        ref = torch.topk(score.masked_fill(~certain[:, lists], -torch.inf),
                         ids.shape[1], dim=1).values
        got = torch.as_tensor(ids[s:s + BLOCK], device=q.device,
                              dtype=torch.int64)
        safe = got.clamp(0, n - 1)
        srt = torch.sort(got, dim=1).values
        bad = (got < 0) | (got >= n) | ~possible.gather(1, lists[safe])
        bad |= torch.cat([torch.zeros_like(srt[:, :1], dtype=torch.bool),
                          srt[:, 1:] == srt[:, :-1]], 1).any(1, keepdim=True)
        sc = torch.where(bad, -torch.inf, score.gather(1, safe))
        sc = torch.sort(sc, dim=1, descending=True).values
        gap = torch.where(torch.isinf(ref) & torch.isinf(sc),
                          torch.zeros_like(ref), ref - sc)
        worst = max(worst, float(gap.max()))
    return worst


def code_gap(x: torch.Tensor, centroids: torch.Tensor, books: torch.Tensor,
             stored_books: torch.Tensor, lists: torch.Tensor,
             codes: torch.Tensor) -> float:
    """Largest gap over the rows ``x`` (s, d) between the squared distance
    to the stored reconstruction (``lists``, ``codes``, decoded with
    ``stored_books``, the books the search decodes with) and the squared
    distance to the reference's: the stored list, then per subspace the
    codeword of ``books`` nearest the residual. +inf where the stored list
    is not within the f32 rounding of an assignment ``argmax 2·x·c −
    |c|²`` of the nearest list."""
    x64, c64 = x.double(), centroids.double()
    m, _, dsub = books.shape
    d = x.shape[1]
    dist = (x64 ** 2).sum(1, keepdim=True) - 2 * x64 @ c64.T \
        + (c64 ** 2).sum(1)[None]
    err = gamma(d + 2) * (2 * x64.abs() @ c64.abs().T
                          + (c64 ** 2).sum(1)[None])
    nearest = (dist + err).min(1).values
    mine = dist.gather(1, lists[:, None])[:, 0] \
        - err.gather(1, lists[:, None])[:, 0]
    if bool((mine > nearest).any()):
        return float("inf")
    resid = (x64 - c64[lists]).reshape(len(x), m, 1, dsub)
    best = ((resid - books.double()[None]) ** 2).sum(-1).min(-1).values
    ref = best.sum(1)
    got = ((x64 - decode(centroids, stored_books, lists, codes)) ** 2).sum(1)
    return float((got - ref).max())
