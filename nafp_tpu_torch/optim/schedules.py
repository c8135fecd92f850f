"""Learning-rate schedules and optimizer selection.

Counterpart of ``nafp_tpu/optim/schedules.py`` (reference
``model/trainer.py:119-140``):
  - 'cos'          tf.keras CosineDecay(alpha=1e-6) over total steps;
  - 'cos-restart'  CosineDecayRestarts(first_decay=10% of total, t_mul=2,
                   m_mul=1, alpha=2e-6);
  - anything else  constant LR.
A schedule maps the 0-based step (the optimizer's count before the
update: step 1 uses ``schedule(0)``) to the learning rate.
Optimizer: 'ADAM' (``torch.optim.Adam`` with TF's eps 1e-7) or 'LAMB'
(``optim/lamb.py``).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Sequence, Tuple

import torch

from nafp_tpu_torch.models.convert import flax_leaf, NORM_KINDS
from nafp_tpu_torch.optim.lamb import Lamb

Schedule = Callable[[int], float]


def cosine_decay(initial_lr: float, decay_steps: int,
                 alpha: float = 1e-6) -> Schedule:
    def schedule(step: int) -> float:
        frac = min(float(step), decay_steps) / decay_steps
        cosined = 0.5 * (1.0 + math.cos(math.pi * frac))
        return initial_lr * ((1 - alpha) * cosined + alpha)
    return schedule


def cosine_decay_restarts(initial_lr: float, first_decay_steps: int,
                          t_mul: float = 2.0, m_mul: float = 1.0,
                          alpha: float = 2e-6) -> Schedule:
    """TF CosineDecayRestarts semantics (SGDR, Loshchilov & Hutter 2016)."""
    def schedule(step: int) -> float:
        completed = float(step) / first_decay_steps
        if t_mul == 1.0:
            i_restart = math.floor(completed)
            frac = completed - i_restart
        else:
            i_restart = math.floor(
                math.log1p(completed * (t_mul - 1.0)) / math.log(t_mul))
            sum_r = (t_mul ** i_restart - 1.0) / (t_mul - 1.0)
            frac = (completed - sum_r) / t_mul ** i_restart
        cosined = 0.5 * m_mul ** i_restart * (1.0 + math.cos(math.pi * frac))
        return initial_lr * ((1 - alpha) * cosined + alpha)
    return schedule


def build_lr_schedule(cfg: Dict[str, Any], total_steps: int) -> Schedule:
    lr = float(cfg["TRAIN"]["LR"])
    kind = str(cfg["TRAIN"]["LR_SCHEDULE"]).upper()
    if kind == "COS":
        return cosine_decay(lr, total_steps, alpha=1e-6)
    if kind == "COS-RESTART":
        return cosine_decay_restarts(lr, max(1, int(total_steps * 0.1)),
                                     alpha=2e-6)
    return lambda step: lr


def flax_keystr(key: str, norm: str) -> str:
    """A parameter's Flax path as ``jax.tree_util.keystr`` spells it
    (``['params']['conv_layer_0']['conv_1x3']['kernel']``): what the JAX
    package's LAMB exclusion patterns are matched against."""
    coll, path, _ = flax_leaf(key, NORM_KINDS[norm])
    return "".join(f"['{p}']" for p in (coll, *path))


def lamb_groups(model: torch.nn.Module,
                exclude_from_weight_decay: Sequence[str] = (),
                exclude_from_layer_adaptation: Sequence[str] = None
                ) -> list:
    """Parameter groups for :class:`Lamb`: a parameter whose Flax path
    contains an excluded pattern gets no weight decay / no trust ratio."""
    if exclude_from_layer_adaptation is None:
        exclude_from_layer_adaptation = exclude_from_weight_decay
    groups: Dict[Tuple[bool, bool], list] = {}
    for key, p in model.named_parameters():
        path = flax_keystr(key, model.norm)
        wd = not any(s in path for s in exclude_from_weight_decay)
        ad = not any(s in path for s in exclude_from_layer_adaptation)
        groups.setdefault((wd, ad), []).append(p)
    return [dict(params=ps, **({} if wd else {"weight_decay": 0.0}),
                 layer_adaptation=ad)
            for (wd, ad), ps in groups.items()]


def build_optimizer(cfg: Dict[str, Any], model: torch.nn.Module,
                    total_steps: int
                    ) -> Tuple[torch.optim.Optimizer, Schedule]:
    """The optimizer over the model's parameters (BatchNorm running
    statistics are buffers: the model updates them, no optimizer does) and
    its learning-rate schedule."""
    schedule = build_lr_schedule(cfg, total_steps)
    name = str(cfg["TRAIN"]["OPTIMIZER"]).upper()
    if name == "LAMB":
        return Lamb(lamb_groups(model), lr=schedule(0)), schedule
    if name == "ADAM":
        return torch.optim.Adam(model.parameters(), lr=schedule(0),
                                eps=1e-7), schedule  # TF Adam default eps
    raise NotImplementedError(cfg["TRAIN"]["OPTIMIZER"])
