"""Plain NT-Xent train steps with LAMB, in float32.

arXiv:2010.11910 §3 and the reference's trainer (``model/trainer.py``,
``model/fp/NTxent_loss_tpu.py``, ``model/fp/lamb_optimizer.py``), on the
batches and random draws the benchmark made:

- replicas: mixed with their background at the drawn SNR and amplitude
  (``portbench.audio.bg_mix``), then convolved with their impulse response
  (cut at 600 taps) as an FFT product of length max(T, L) truncated to T,
  and max-normalised; anchors are left as they are;
- log-mel of anchors and replicas together (one batch max), SpecAugment
  holes (the drawn ranges, one mask for the batch, filled with zeros);
- NT-Xent at temperature tau over [a·bᵀ, a·aᵀ without the diagonal] and
  its mirror, summed over both halves and divided by the anchors;
- LAMB: Adam moments with bias correction at the 1-based step,
  update = m̂ / (√v̂ + eps) + wd·w, trust ratio ‖w‖ / ‖update‖ per tensor
  (1 when either is 0), w -= lr · ratio · update; the learning rate is the
  cosine decay (alpha 1e-6) at the 0-based step.

``precision`` is the encoder's (see ``encoder``); ``half``: the loss of
only the first half of the anchors and their replicas (a planted fault).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List

import torch

from portbench import audio
from portbench.reference.encoder import LogMel, encode


def augment(batch: Dict[str, torch.Tensor], draws: Dict[str, Any],
            ir_taps: int) -> torch.Tensor:
    xp = audio.bg_mix(batch["replicas"], batch["bg"], draws["snr"],
                      draws["amp"])
    t = xp.shape[-1]
    ir = batch["ir"][:, :ir_taps]
    n = max(t, ir.shape[-1])
    y = torch.fft.irfft(torch.fft.rfft(xp, n=n) * torch.fft.rfft(ir, n=n),
                        n=n)[:, :t]
    m = y.abs().amax(-1, keepdim=True)
    return torch.where(m > 0, y / torch.where(m > 0, m, 1.0), y)


def holes(feat: torch.Tensor, spec: List[Dict[str, Any]]) -> torch.Tensor:
    """(B, F, T) features with each layer's drawn holes zeroed (its
    ``ranges`` (y0, y1, x0, x1), inclusive, shared by the batch; ``act``
    (B, 1, 1, 1) says which rows it applies to)."""
    _, h, w = feat.shape
    iy = torch.arange(h, device=feat.device)
    ix = torch.arange(w, device=feat.device)
    for layer in spec:
        y0, y1, x0, x1 = (r.reshape(-1) for r in layer["ranges"])
        mask = torch.zeros((h, w), dtype=torch.bool, device=feat.device)
        for j in range(len(y0)):
            mask |= (((y0[j] <= iy) & (iy <= y1[j]))[:, None]
                     & ((x0[j] <= ix) & (ix <= x1[j]))[None, :])
        mask = mask[None] & layer["act"].reshape(-1, 1, 1)
        feat = torch.where(mask, torch.zeros_like(feat), feat)
    return feat


def ntxent(a: torch.Tensor, b: torch.Tensor, tau: float) -> torch.Tensor:
    n = a.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=a.device)
    ab, aa = a @ b.T / tau, (a @ a.T / tau).masked_fill(eye, -torch.inf)
    ba, bb = b @ a.T / tau, (b @ b.T / tau).masked_fill(eye, -torch.inf)
    la = torch.logsumexp(torch.cat([ab, aa], 1), 1) - ab.diagonal()
    lb = torch.logsumexp(torch.cat([ba, bb], 1), 1) - ba.diagonal()
    return (la.sum() + lb.sum()) / n


def cosine_lr(opt: Dict[str, Any], step: int) -> float:
    frac = min(step, opt["total_steps"]) / opt["total_steps"]
    cos = 0.5 * (1 + math.cos(math.pi * frac))
    return opt["lr"] * ((1 - opt["alpha"]) * cos + opt["alpha"])


def steps(w0: Dict[str, torch.Tensor], batches, draws, cfg: Dict[str, Any],
          precision: str = "f32", half: bool = False) -> Dict[str, Any]:
    """Run len(batches) steps from ``w0``. Returns the losses, each leaf's
    gradient norm at the first step, and each leaf's change norm after
    the last."""
    m, opt = cfg["model"], cfg["optimizer"]
    b1, b2 = opt["betas"]
    logmel = LogMel(m, next(iter(w0.values())).device)
    w = {k: v.detach().clone().requires_grad_(True) for k, v in w0.items()}
    mom = {k: torch.zeros_like(v) for k, v in w0.items()}
    vel = {k: torch.zeros_like(v) for k, v in w0.items()}
    losses, grad_norms = [], {}
    for t, (batch, dr) in enumerate(zip(batches, draws), start=1):
        xp = augment(batch, dr["td"], cfg["ir_taps"])
        feat = holes(logmel(torch.cat([batch["anchors"], xp])), dr["spec"])
        emb = encode(feat, w, m, precision)
        n = batch["anchors"].shape[0]
        a, b = emb[:n], emb[n:]
        if half:
            a, b = a[:n // 2], b[:n // 2]
        loss = ntxent(a, b, cfg["tau"])
        grads = torch.autograd.grad(loss, list(w.values()))
        losses.append(float(loss.detach()))
        lr = cosine_lr(opt, t - 1)
        with torch.no_grad():
            for (k, p), g in zip(w.items(), grads):
                if t == 1:
                    grad_norms[k] = float(torch.linalg.vector_norm(g))
                mom[k].mul_(b1).add_(g, alpha=1 - b1)
                vel[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                u = (mom[k] / (1 - b1 ** t)) / (
                    torch.sqrt(vel[k] / (1 - b2 ** t)) + opt["eps"])
                u = u + opt["weight_decay"] * p
                wn, un = torch.linalg.vector_norm(p), torch.linalg.vector_norm(u)
                ratio = wn / un if float(wn) > 0 and float(un) > 0 else 1.0
                p -= lr * ratio * u
    with torch.no_grad():
        change = {k: float(torch.linalg.vector_norm(w[k] - w0[k]))
                  for k in w}
    return {"losses": losses, "grad_norms": grad_norms, "change": change}


def worst_leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
                   ref_grad: Dict[str, float]) -> float:
    """Largest |prog - ref| of a leaf's norm, over the larger of the
    reference's norm of that leaf and of the median leaf; leaves whose
    reference gradient is under a thousandth of the median leaf's are
    left out (they move by round-off alone)."""
    med_g = sorted(ref_grad.values())[len(ref_grad) // 2]
    med = sorted(ref.values())[len(ref) // 2]
    worst = 0.0
    for k, r in ref.items():
        if ref_grad[k] < 1e-3 * med_g:
            continue
        worst = max(worst, abs(prog[k] - r) / max(r, med))
    return worst
