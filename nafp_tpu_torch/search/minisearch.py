"""In-memory mini-search used for validation during training.

Counterpart of ``nafp_tpu/search/minisearch.py`` (reference
``mini_search_subroutines.py:30-236``). Multi-segment sequences are scored
by the reference's identity-kernel convolution of the pairwise distance
matrix ("conv_eye", :93-120), here a diagonal-band sum of shifted slices.

Inputs follow the reference: query ``(nQ, nAug, d)``, db ``(nD, d)``;
modes 'argmin' (squared L2) and 'argmax' (inner product). Distances are
full-f32 products (TF32 is off on the card).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def pairwise_distances(query: torch.Tensor, db: torch.Tensor,
                       return_dotprod: bool = False,
                       squared: bool = True) -> torch.Tensor:
    """(nAug, nQ, nD) distance/similarity tensor (reference :30-90)."""
    query, db = query.float(), db.float()
    dot = torch.einsum("qad,nd->aqn", query, db)
    if return_dotprod:
        return dot
    q_sq = torch.sum(query ** 2, dim=2).T[:, :, None]   # (nAug, nQ, 1)
    d_sq = torch.sum(db ** 2, dim=1)[None, None, :]     # (1, 1, nD)
    dists = torch.clamp(q_sq + d_sq - 2.0 * dot, min=0.0)
    if not squared:
        dists = torch.sqrt(dists + 1e-16)
    return dists


def conv_eye(x: torch.Tensor, scope: int) -> torch.Tensor:
    """Diagonal-band sum: out[a,q,n] = sum_{k<scope} x[a, q+k, n+k]."""
    _, nq, nd = x.shape
    acc = x[:, :nq - scope + 1, :nd - scope + 1]
    for k in range(1, scope):
        acc = acc + x[:, k:nq - scope + 1 + k, k:nd - scope + 1 + k]
    return acc


def _ranks_for_scope(all_d: torch.Tensor, scope: int, sign: float,
                     gt_id_offset: int) -> torch.Tensor:
    """Rank of the ground-truth db row per (aug, target): #(strictly
    better) + #(ties other than the gt itself), no argsort. Ties count
    AGAINST the gt: a collapsed model (all embeddings identical) must read
    as ~0 % top-1, not 100 %."""
    d = conv_eye(all_d, scope) * sign
    gt = torch.arange(d.shape[1], device=d.device) + gt_id_offset
    d_gt = torch.gather(d, 2, gt[None, :, None].expand(d.shape[0], -1, 1))
    return (torch.sum(d < d_gt, dim=2)
            + torch.sum(d == d_gt, dim=2) - 1)                # (nAug, nQ')


def mini_search_eval(query: torch.Tensor,
                     db: torch.Tensor,
                     scopes: Sequence[int] = (1, 3, 5, 9, 11, 19),
                     mode: str = "argmin",
                     display: bool = True,
                     gt_id_offset: int = 0
                     ) -> Tuple[Tuple[np.ndarray, np.ndarray, np.ndarray],
                                np.ndarray]:
    """((top1, top3, top10) accuracies %, mean_rank) per scope (reference
    :123-236). Ground truth: query i matches db row i (+ offset)."""
    if mode == "argmin":
        all_d, sign = pairwise_distances(query, db, squared=True), 1.0
    elif mode.lower() == "argmax":
        all_d = pairwise_distances(query, db, return_dotprod=True)
        sign = -1.0  # larger is better -> negate
    else:
        raise NotImplementedError(mode)

    n_scopes = len(scopes)
    top1, top3, top10, mean_rank = (np.zeros(n_scopes) for _ in range(4))
    for i, s in enumerate(scopes):
        ranks = _ranks_for_scope(all_d, int(s), sign,
                                 int(gt_id_offset)).cpu().numpy()
        mean_rank[i] = ranks.mean()
        top1[i] = (ranks < 1).mean()
        top3[i] = (ranks < 3).mean()
        top10[i] = (ranks < 10).mean()
    top1, top3, top10 = top1 * 100, top3 * 100, top10 * 100

    if display:
        cyan, reset = "\033[36m", "\033[0m"
        print(cyan + "Scope:\t" + "\t".join(f"{s:^6}" for s in scopes) + reset)
        print(cyan + "T1acc:\t" + reset +
              "\t".join(f"{v:>4.2f}" for v in top1))
        print(cyan + "mRank:\t" + reset +
              "\t".join(f"{v:>4.2f}" for v in mean_rank))
    return (top1, top3, top10), mean_rank
