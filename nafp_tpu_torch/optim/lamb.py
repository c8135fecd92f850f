"""LAMB as a ``torch.optim.Optimizer``.

Counterpart of ``nafp_tpu/optim/lamb.py``, with the TF-Addons semantics the
reference vendors (``model/fp/lamb_optimizer.py:26-158``): Adam moments with
bias correction at the 1-based step, ``update = m_hat / (sqrt(v_hat) + eps)
+ wd * w``, a per-tensor trust ratio ``||w|| / ||update||`` (1.0 when either
norm is 0), ``w -= lr * ratio * update``. Defaults: beta1 .9, beta2 .999,
eps 1e-6, wd 1e-6.

The trust ratio is taken per parameter tensor; each of the port's tensors
is exactly one Flax leaf (``models/convert.flax_leaf``), and the layout
transposes leave norms unchanged. Exclusions are per parameter group
(``weight_decay`` 0 or ``layer_adaptation`` False); ``optim/schedules``
builds the groups from Flax-path patterns, as the JAX package matches them.
The learning rate is the group's ``lr``, which the trainer sets from the
schedule at the pre-increment step before each update.
"""
from __future__ import annotations

import torch


class Lamb(torch.optim.Optimizer):
    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999),
                 eps: float = 1e-6, weight_decay: float = 1e-6,
                 layer_adaptation: bool = True):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay,
                                      layer_adaptation=layer_adaptation))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            lr, eps, wd = group["lr"], group["eps"], group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["exp_avg"] = torch.zeros_like(p)
                    state["exp_avg_sq"] = torch.zeros_like(p)
                state["step"] += 1
                t = state["step"]
                m, v = state["exp_avg"], state["exp_avg_sq"]
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                update = (m / (1 - b1 ** t)) / ((v / (1 - b2 ** t)).sqrt()
                                                + eps)
                if wd:
                    update.add_(p, alpha=wd)
                if group["layer_adaptation"]:
                    w_norm = torch.linalg.vector_norm(p)
                    u_norm = torch.linalg.vector_norm(update)
                    ratio = torch.where(
                        (w_norm > 0) & (u_norm > 0),
                        w_norm / torch.where(u_norm > 0, u_norm, 1.0), 1.0)
                    p.add_(-lr * ratio * update)
                else:
                    p.add_(update, alpha=-lr)
        return loss
