"""Plain exact search and sequence re-rank of the ICASSP protocol, judged by
score gaps.

arXiv:2010.11910 §4 (the reference's ``eval/eval_faiss.py:93-275``): each
query segment's k nearest DB rows by inner product (the fingerprints are
unit vectors, so that is the L2 order); each hit id minus its segment's
offset is a candidate start; negative and duplicate starts are dropped,
as are windows that run past the DB; a candidate's sequence score is the
mean over the query's valid segments of q_j · db[start + j]; the answer is
the best 10 by score.

With random weights many rows lie within rounding of each other, so ids
are not compared. A search answer is judged by how far the true score of
its j-th best returned row lies below the true j-th best score of the DB
(``topk_gap``); a ranked answer by how far the true sequence score of its
j-th pick lies below the j-th best candidate's (``rerank_gap``). True
scores are float64 products of the vectors the search was given.
"""
from __future__ import annotations

import numpy as np
import torch

BLOCK = 256          # query rows per float64 product block


def topk_gap(q: torch.Tensor, db: torch.Tensor, ids: np.ndarray) -> float:
    """Largest gap over the rows of ``q`` (n, d) between the DB's true
    j-th best score and the true score of the j-th best of ``ids`` (n, k)
    (a missing or repeated id counts as -inf)."""
    n, k = ids.shape
    worst = 0.0
    db64 = db.double()
    for s in range(0, n, BLOCK):
        true = q[s:s + BLOCK].double() @ db64.T
        best = torch.topk(true, k, dim=1).values
        got = torch.as_tensor(ids[s:s + BLOCK], device=q.device,
                              dtype=torch.int64)
        bad = (got < 0) | (got >= db.shape[0])
        srt = torch.sort(got, dim=1).values
        bad |= torch.cat([torch.zeros_like(srt[:, :1], dtype=torch.bool),
                          srt[:, 1:] == srt[:, :-1]], 1).any(1, keepdim=True)
        sc = true.gather(1, got.clamp(0, db.shape[0] - 1))
        sc = torch.where(bad, -torch.inf, sc)
        sc = torch.sort(sc, dim=1, descending=True).values
        worst = max(worst, float((best - sc).max()))
    return worst


def rerank(q_seq: torch.Tensor, n_seg: torch.Tensor, hit_ids: np.ndarray,
           recon: torch.Tensor, k_out: int = 10) -> torch.Tensor:
    """(b, k_out) true sequence scores of the best candidates (best first,
    -inf where fewer are valid) and the (b, C) scores of every candidate.
    ``q_seq`` (b, sl, d) with rows past ``n_seg`` zero; ``hit_ids`` (b, sl,
    k) segment hits, -1 for none."""
    b, sl, _ = q_seq.shape
    n = recon.shape[0]
    hits = torch.as_tensor(hit_ids, device=recon.device, dtype=torch.int64)
    off = torch.arange(sl, device=recon.device)[None, :, None]
    valid_seg = off < n_seg[:, None, None]
    starts = torch.where((hits >= 0) & valid_seg, hits - off,
                         torch.full_like(hits, -1)).reshape(b, -1)
    starts = torch.sort(starts, dim=1).values
    dup = torch.cat([torch.zeros_like(starts[:, :1], dtype=torch.bool),
                     starts[:, 1:] == starts[:, :-1]], 1)
    bad = (starts < 0) | (starts + n_seg[:, None] > n) | dup
    win = (starts.clamp(0, n - 1)[:, :, None]
           + torch.arange(sl, device=recon.device)).clamp(max=n - 1)
    rows = recon.double()[win]                            # (b, C, sl, d)
    scores = torch.einsum("bsd,bcsd->bc", q_seq.double(), rows) \
        / n_seg[:, None].double()
    scores = scores.masked_fill(bad, -torch.inf)
    return scores, starts


def rerank_gap(q_seq, n_seg, hit_ids, recon, pred: np.ndarray) -> float:
    """Largest gap over a block between the j-th best candidate's true
    sequence score and the true score of the answer's j-th pick ``pred``
    (b, 10) (-999999 = no pick: right only where no valid candidate is
    left)."""
    scores, starts = rerank(q_seq, n_seg, hit_ids, recon)
    k = pred.shape[1]
    best = torch.topk(scores, k, dim=1).values
    p = torch.as_tensor(pred, device=recon.device, dtype=torch.int64)
    hit = (starts[:, None, :] == p[:, :, None])           # (b, k, C)
    picked = torch.where(hit, scores[:, None, :],
                         torch.full_like(scores[:, None, :], -torch.inf)
                         ).amax(-1)
    none = p == -999999
    srt = torch.sort(torch.where(none, -1 - torch.arange(
        k, device=p.device), p), dim=1).values
    picked = torch.where((srt[:, 1:] == srt[:, :-1]).any(1, keepdim=True),
                         -torch.inf, picked)             # a pick repeated
    # a pick that is no valid candidate, or no pick where one is left
    gap = torch.where(none & torch.isinf(best), torch.zeros_like(best),
                      best - picked)
    return float(gap.max())
