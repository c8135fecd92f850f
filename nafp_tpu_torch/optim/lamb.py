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

A group whose parameters lie on the CPU takes the plain version, a loop
over the leaves (``plain_update``). On the card every leaf with a gradient
is updated by the kernel pair of ``csrc/lamb.cu``: the leaves of all groups
that share lr, betas, eps and step go into launches of at most
``MAX_LEAVES`` leaves (``launch_plan``), two kernels each, whose leaf table
(``leaf_table``: pointers, sizes, chunk offsets, weight decay, adaptation
flag) is gathered every step, since ``zero_grad(set_to_none=True)`` may
hand autograd new gradient tensors and a restored state brings new moment
tensors. A CUDA parameter that is not a contiguous f32 tensor raises. The
state keeps its layout (``step``, ``exp_avg``, ``exp_avg_sq``, updated in
place). ``LAUNCHES`` counts the kernels launched; the port's counter
``lamb.fused_leaves`` the leaves they updated.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from nafp_tpu_torch import kernels
from nafp_tpu_torch.utils.profiling import count

CHUNK = 4096            # csrc/lamb.cu CHUNK: elements a CTA
MAX_LEAVES = 80         # csrc/lamb.cu MAX_LEAVES: leaves a launch
MAX_NUMEL = 2 ** 31 - 1  # a leaf's size is an int there

LAUNCHES: Dict[str, int] = {"lamb_moments": 0, "lamb_apply": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


class Leaf(NamedTuple):
    """One parameter's update on the card: its tensors, its group's
    scalars and the step this update makes (1-based)."""
    p: torch.Tensor
    g: torch.Tensor
    m: torch.Tensor
    v: torch.Tensor
    lr: float
    betas: Tuple[float, float]
    eps: float
    wd: float
    adapt: bool
    step: int


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
        fused: List[Leaf] = []
        states: List[dict] = []
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            if kernels.all_on_cpu(*params, *(p.grad for p in params)):
                for p in params:
                    plain_update(p, p.grad, self._state(p), group)
                continue
            scalars = (float(group["lr"]),
                       tuple(float(b) for b in group["betas"]),
                       float(group["eps"]), float(group["weight_decay"]),
                       bool(group["layer_adaptation"]))
            for p in params:
                state = self._state(p)
                states.append(state)
                fused.append(Leaf(p, p.grad, state["exp_avg"],
                                  state["exp_avg_sq"], *scalars,
                                  state["step"] + 1))
        if fused:
            count("lamb.fused_leaves", fused_update(fused))
            for state in states:
                state["step"] += 1
        return loss

    def _state(self, p: torch.Tensor) -> dict:
        state = self.state[p]
        if not state:
            state["step"] = 0
            state["exp_avg"] = torch.zeros_like(p)
            state["exp_avg_sq"] = torch.zeros_like(p)
        return state


def plain_update(p: torch.Tensor, g: torch.Tensor, state: dict,
                 group: dict) -> None:
    """One leaf's update, one PyTorch operation at a time (the CPU route)."""
    b1, b2 = group["betas"]
    lr, eps, wd = group["lr"], group["eps"], group["weight_decay"]
    state["step"] += 1
    t = state["step"]
    m, v = state["exp_avg"], state["exp_avg_sq"]
    m.mul_(b1).add_(g, alpha=1 - b1)
    v.mul_(b2).addcmul_(g, g, value=1 - b2)
    update = (m / (1 - b1 ** t)) / ((v / (1 - b2 ** t)).sqrt() + eps)
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


def chunks_of(n: int) -> int:
    """The CTAs of a leaf of ``n`` elements."""
    return -(-n // CHUNK)


def launch_plan(leaves: Sequence[Leaf]) -> List[List[Leaf]]:
    """The launches of one step: the leaves with elements, grouped by
    device and the scalars a launch shares (lr, betas, eps, step), in runs
    of at most ``MAX_LEAVES``, in the order given."""
    runs: Dict[tuple, List[Leaf]] = {}
    for leaf in leaves:
        if leaf.p.numel():
            key = (leaf.p.device, leaf.lr, leaf.betas, leaf.eps, leaf.step)
            runs.setdefault(key, []).append(leaf)
    return [run[i:i + MAX_LEAVES] for run in runs.values()
            for i in range(0, len(run), MAX_LEAVES)]


def leaf_table(launch: Sequence[Leaf]) -> Tuple[np.ndarray, ...]:
    """The host arrays ``nafp_lamb_step`` reads for one launch: the
    addresses of p, g, m and v (4·n int64, p's first), the sizes (int32),
    the n + 1 chunk offsets (int32), weight decay (f32) and the adaptation
    flag (int32) of each leaf."""
    ptrs = np.array([leaf[k].data_ptr() for k in range(4) for leaf in launch],
                    dtype=np.int64)
    sizes = np.array([leaf.p.numel() for leaf in launch], dtype=np.int32)
    chunk0 = np.zeros(len(launch) + 1, dtype=np.int32)
    np.cumsum([chunks_of(int(n)) for n in sizes], out=chunk0[1:])
    wd = np.array([leaf.wd for leaf in launch], dtype=np.float32)
    adapt = np.array([leaf.adapt for leaf in launch], dtype=np.int32)
    return ptrs, sizes, chunk0, wd, adapt


def _check_leaf(leaf: Leaf) -> None:
    dev, n = leaf.p.device, leaf.p.numel()
    for name, t in zip(("p", "grad", "exp_avg", "exp_avg_sq"), leaf[:4]):
        if t.dtype != torch.float32 or t.device != dev or t.layout != \
                torch.strided or not t.is_contiguous() or t.numel() != n:
            raise ValueError(
                f"LAMB on the card takes contiguous f32 tensors of one "
                f"shape on one device: {name} is {t.dtype} "
                f"{tuple(t.shape)} {t.layout} on {t.device}")
    if n > MAX_NUMEL:
        raise ValueError(f"LAMB on the card: a leaf of {n} elements, at most "
                         f"{MAX_NUMEL}")


_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p]
             + [ctypes.c_float] * 8 + [ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _lib_fn():
    return kernels.function("lamb", _ARGTYPES, "_step")


def fused_update(leaves: Sequence[Leaf]) -> int:
    """Update ``leaves`` (CUDA tensors; ``step`` the one this update makes)
    by the kernel pair, two launches per ``launch_plan`` entry, after every
    leaf is checked; returns the leaves updated (those with elements)."""
    for leaf in leaves:
        _check_leaf(leaf)
    plan = launch_plan(leaves)
    for launch in plan:
        first = launch[0]
        (b1, b2), t, dev = first.betas, first.step, first.p.device
        ptrs, sizes, chunk0, wd, adapt = leaf_table(launch)
        partials = torch.empty(2 * int(chunk0[-1]), dtype=torch.float32,
                               device=dev)
        with torch.cuda.device(dev):
            err = _lib_fn()(
                ptrs.ctypes.data, sizes.ctypes.data, chunk0.ctypes.data,
                wd.ctypes.data, adapt.ctypes.data, len(launch),
                partials.data_ptr(), first.lr, b1, 1 - b1, b2, 1 - b2,
                1 - b1 ** t, 1 - b2 ** t, first.eps,
                torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"nafp_lamb_step kernel launch failed: CUDA "
                               f"error {err}")
        LAUNCHES["lamb_moments"] += 1
        LAUNCHES["lamb_apply"] += 1
    return sum(len(launch) for launch in plan)
