"""Online triplet-mining loss (FaceNet / Now-Playing variant).

Counterpart of ``nafp_tpu/losses/triplet.py`` (reference
``model/fp/online_triplet_loss.py:34-239``). Selected by
``LOSS.LOSS_MODE: 'Online-Triplet'`` (the ``now_playing`` preset); the
trainer mines with ``LOSS.MINING_MODE`` (default 'semi-hard') in training
and with mode 'all' at margin 0 in validation.

Batch layout: ``emb_anchor`` (A, d) anchors and ``emb_pos`` (A*P, d)
replicas, the replicas of anchor i at rows [i*P, (i+1)*P). With
``use_anc_as_pos`` the anchors are appended as extra columns and each
anchor's own column is left out of its negatives (the identity block).

Distances are the cosine -> L2 conversion ``d = sqrt(2(1 - a·b) + EPS)``
of the reference's fast path (:183-194); the inputs must be
L2-normalised. The products are full f32 (the JAX package's
``Precision.HIGHEST``; TF32 is off on the card, ``device.py``), and a
non-positive ``2(1 - a·b)`` is zeroed under the square root, so the
identity block sits at ``sqrt(EPS)``.

The reductions per mode are the reference's (:211-236), the 'all' mode
pairing elementwise (not all pairs). Two deliberate fixes, as in the JAX
package: (1) ``num_active`` counts the positive elements *before* the
mean (the reference counts on the reduced scalar, :238, always 0 or 1);
(2) 'hardest' masks the non-negatives with +inf before the min (the
reference mins the mask-zeroed matrix, :227-229, so its closest negative
is identically 0 and the mode degenerates to mean(relu(hardest_ap +
margin))).

Gradients follow JAX's at ties: ``torch.amax``/``torch.amin`` share the
gradient evenly among tied entries (``torch.max(dim)`` would send it all
to one index), and ``torch.maximum`` halves it where the hinge sits
exactly at 0, as ``jnp.maximum`` does.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

EPS = 1e-9
MODES = ("semi-hard", "hardest", "all", "all-balanced")


def _masks(n_anchor: int, n_pos_per_anchor: int, use_anc_as_pos: bool
           ) -> Tuple[np.ndarray, np.ndarray]:
    """Anchor-positive / anchor-negative masks (reference :95-114)."""
    n_pos = n_anchor * n_pos_per_anchor
    n_cols = n_pos + (n_anchor if use_anc_as_pos else 0)
    ap = np.zeros((n_anchor, n_cols), np.float32)
    for a in range(n_anchor):
        ap[a, a * n_pos_per_anchor:(a + 1) * n_pos_per_anchor] = 1.0
    an = 1.0 - ap
    if use_anc_as_pos:
        an[:, n_pos:] = 1.0 - np.eye(n_anchor, dtype=np.float32)
    return ap, an


def online_triplet_loss(emb_anchor: torch.Tensor,
                        emb_pos: torch.Tensor,
                        n_anchor: int,
                        n_pos_per_anchor: int,
                        margin: float = 0.5,
                        mode: str = "semi-hard",
                        use_anc_as_pos: bool = True,
                        squared: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (loss, pairwise distances (A, cols), num_active_triplets)."""
    if mode not in MODES:
        raise NotImplementedError(mode)
    dev = emb_anchor.device
    ap_np, an_np = _masks(n_anchor, n_pos_per_anchor, use_anc_as_pos)
    ap_mask = torch.from_numpy(ap_np).to(dev)
    an_mask = torch.from_numpy(an_np).to(dev)

    a = emb_anchor.float()
    cols = torch.cat([emb_pos, emb_anchor]) if use_anc_as_pos else emb_pos
    dists = 2.0 * (1.0 - a @ cols.float().T)
    if not squared:
        pos = (dists > 0.0).float()
        dists = torch.sqrt(dists * pos + EPS)

    zero = dists.new_zeros(())
    ap_d = dists * ap_mask
    if mode == "all":
        per_elem = torch.maximum(ap_d - dists * an_mask + margin, zero)
    elif mode == "all-balanced":
        ap_row = ap_d.sum(1) / ap_mask.sum(1)
        an_row = (dists * an_mask).sum(1) / an_mask.sum(1)
        per_elem = torch.maximum(ap_row - an_row + margin, zero)
    elif mode == "hardest":
        an_row = torch.amin(torch.where(an_mask > 0, dists,
                                        torch.full_like(dists, np.inf)), 1)
        ap_row = torch.amax(ap_d, 1)
        per_elem = torch.maximum(ap_row - an_row + margin, zero)
    else:  # semi-hard
        hardest_ap = torch.amax(ap_d, 1, keepdim=True)
        per_elem = torch.maximum((hardest_ap - dists + margin) * an_mask,
                                 zero)
    loss = per_elem.mean()
    num_active = (per_elem > 0.0).float().sum()
    return loss, dists, num_active
