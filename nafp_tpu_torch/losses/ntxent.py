"""NT-Xent (normalized temperature cross-entropy) in its local-rows form.

Counterpart of ``nafp_tpu/losses/ntxent.py``. With ``ha`` the anchors and
``hb`` the replicas (L2-normalised, n rows each), row i of part a is a
softmax cross-entropy over ``[ha_i·hb_*, ha_i·ha_{*≠i}] / tau`` with its
label at the position of ``hb_i``; part b is symmetric; the loss is
mean_a + mean_b. The aa/bb self-similarities are masked with
``−LARGE_NUM`` (the same softmax as dropping the diagonal), so shapes stay
static.

The loss is written for a shard of a larger batch: a caller holding
``n_local`` rows passes the gathered global rows and its ``offset`` among
them, computes only its rows of the global logits, and divides by the
global row count, so the shards' losses sum to the whole batch's. With
one replica (no ``gathered``) it is the plain single-device loss. Under
``torch.distributed`` the trainer gathers the rows with
``parallel.mesh.all_gather`` (whose backward sums the cotangent over the
ranks), passes ``offset = rank · n_local``, and reports the sum of the
ranks' shares (the JAX package's ``psum`` of ``loss_sum``).

The logits are full-f32 products (the JAX package's ``Precision.HIGHEST``):
tau = 0.05 scales similarity rounding by 20 in logit space. On the card
TF32 is off (``device.set_f32_precision``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

LARGE_NUM = 1e9  # diagonal mask value (reference NTxent_loss_tpu.py:117-119)


def ntxent_loss(emb_org: torch.Tensor,
                emb_rep: torch.Tensor,
                tau: float = 0.05,
                gathered: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """NT-Xent of local rows against the global batch.

    Args:
      emb_org: (n_local, d) L2-normalised anchor embeddings.
      emb_rep: (n_local, d) L2-normalised replica embeddings.
      tau: temperature.
      gathered: (ha_global, hb_global), each (n_global, d), holding these
        rows at ``[offset, offset + n_local)``; None = the local rows are
        the whole batch.
      offset: this shard's first row in the global batch.

    Returns:
      (loss, logits_a): this shard's share of the scalar global loss, and
      its rows of the ``[ab, aa_masked]`` logits (the similarity matrix the
      trainer images).
    """
    ha, hb = emb_org.float(), emb_rep.float()
    n_local = ha.shape[0]
    ha_g, hb_g = (ha, hb) if gathered is None else (gathered[0].float(),
                                                    gathered[1].float())
    n_global = ha_g.shape[0]

    logits_ab = ha @ hb_g.T / tau
    logits_aa = ha @ ha_g.T / tau
    logits_ba = hb @ ha_g.T / tau
    logits_bb = hb @ hb_g.T / tau

    rows = torch.arange(n_local, device=ha.device)[:, None]
    cols = torch.arange(n_global, device=ha.device)[None, :]
    self_mask = (cols == rows + offset).float()
    logits_aa = logits_aa - self_mask * LARGE_NUM
    logits_bb = logits_bb - self_mask * LARGE_NUM

    labels = torch.arange(n_local, device=ha.device) + offset
    logits_a = torch.cat([logits_ab, logits_aa], dim=1)   # (n_l, 2 n_g)
    logits_b = torch.cat([logits_ba, logits_bb], dim=1)

    def _ce(logits):
        pos = torch.gather(logits, 1, labels[:, None])[:, 0]
        return torch.logsumexp(logits, dim=1) - pos

    loss = (_ce(logits_a).sum() + _ce(logits_b).sum()) / n_global
    return loss, logits_a
