"""Plain exact re-rank of an IVF-PQ shortlist in float64, judged by score
gaps.

IVF-PQ with a refinement stage as the reference sets it up
(``eval/get_index_faiss.py:77-83``, FAISS ``IndexIVFPQR``): the IVF-PQ
search (``reference/ivfpq.py``) keeps a shortlist of ``k_factor · k``
candidates by their asymmetric distance, and a second stage re-scores
that shortlist and keeps the best k. A shortlist slot holds a row id, or
-1 where the probed lists held fewer rows than the shortlist has slots.

Everything works from the shortlist the port kept, the raw f32 rows and
the f32 queries, as float64: the f32 values are exact in it, and TF32
(which the runner's check switches off first,
``reference/encoder.py::no_tf32``) never touches a float64 product.
Departures from the published description, each for the check's sake or
inherited from the program it judges:

- the second stage re-scores with the raw f32 rows (FAISS
  ``IVFPQ,RFlat``), where ``IndexIVFPQR`` re-scores with a second PQ of 4
  bits a code on the first stage's residuals: the port keeps the raw rows
  on the card, as the JAX package does;
- scores are inner products: the rows are L2-normalised fingerprints, so
  the ranking is the L2 ranking;
- the shortlist is the port's own, judged on its own by
  ``reference/ivfpq.py::pq_gap`` at its full width; this file judges the
  re-rank of it alone;
- equal float64 scores go to the lower shortlist slot.

An answer is judged by ``refine_gap``, the widest of (a) how far the
float64 score of its j-th id lies below the float64 j-th best over the
shortlist, and (b) how far its reported score lies from the float64
score of its id. An id that is not in the shortlist, or that the answer
repeats, reads +inf; so does an empty answer slot (-1) where the
shortlist still holds a row, or whose score is not -inf.
"""
from __future__ import annotations

from typing import Tuple

import torch

BLOCK = 256          # query rows per float64 block


def rescore(q: torch.Tensor, raw: torch.Tensor, shortlist: torch.Tensor
            ) -> torch.Tensor:
    """(nq, w) float64 ``q · raw[id]`` of each shortlist slot of ``q``
    (nq, d), -inf where the slot is empty (-1)."""
    sl = shortlist.long()
    rows = raw[sl.clamp(min=0)].double()                  # (nq, w, d)
    s = torch.einsum("nd,nwd->nw", q.double(), rows)
    return s.masked_fill(sl < 0, -torch.inf)


def refine(q: torch.Tensor, raw: torch.Tensor, shortlist: torch.Tensor,
           k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The exact top ``k`` of each row's shortlist: float64 scores (nq, k)
    descending and int64 ids, ties to the lower slot; -inf / -1 where the
    shortlist holds fewer than k rows."""
    s = rescore(q, raw, shortlist)
    v, slot = torch.sort(s, dim=1, descending=True, stable=True)
    v, slot = v[:, :k], slot[:, :k]
    ids = shortlist.long().gather(1, slot)
    return v, torch.where(torch.isinf(v), -1, ids)


def refine_gap(q: torch.Tensor, raw: torch.Tensor, shortlist, scores,
               ids) -> float:
    """Largest gap over the rows of ``q`` (nq, d) between the port's
    answer (``scores`` (nq, k) as reported, ``ids`` (nq, k)) and the exact
    re-rank of ``shortlist`` (nq, w): see the module's docstring."""
    dev = q.device
    worst = 0.0
    for s in range(0, len(q), BLOCK):
        qb = q[s:s + BLOCK]
        short = torch.as_tensor(shortlist[s:s + BLOCK], device=dev).long()
        got_i = torch.as_tensor(ids[s:s + BLOCK], device=dev).long()
        got_s = torch.as_tensor(scores[s:s + BLOCK], device=dev).double()
        exact = rescore(qb, raw, short)                       # (b, w)
        ref = torch.sort(exact, dim=1, descending=True).values[
            :, :got_i.shape[1]]
        match = (got_i[:, :, None] == short[:, None, :]) \
            & (short[:, None, :] >= 0)                        # (b, k, w)
        mine = torch.where(match, exact[:, None, :],
                           torch.full_like(exact[:, None, :], -torch.inf)
                           ).max(2).values                    # (b, k)
        srt = torch.sort(got_i, dim=1).values
        dup = ((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).any(
            1, keepdim=True)
        bad = (got_i >= 0) & (~match.any(2) | dup)
        empty = got_i < 0
        inf = torch.full_like(ref, torch.inf)
        zero = torch.zeros_like(ref)
        below = torch.where(empty, torch.where(torch.isinf(ref), zero, inf),
                            ref - mine)
        off = torch.where(empty,
                          torch.where(got_s == -torch.inf, zero, inf),
                          (got_s - mine).abs())
        gap = torch.where(bad, inf, torch.maximum(below, off))
        worst = max(worst, float(gap.max()))
    return worst
