"""Devices and processes of a data-parallel run.

Counterpart of ``nafp_tpu/parallel/mesh.py``. The JAX package runs one
controller over a ``('data',)`` device mesh; PyTorch's idiom has two
levels, and this module holds both:

- one process driving several devices: :func:`data_devices` (generate's
  batch split, ``DEVICE.MESH_DATA_PARALLEL``) and :func:`local_devices`
  (the sharded indexes' default, one shard per card). A list may repeat a
  device: several shards on one card, or on the CPU;
- one process per card, joined by ``torch.distributed`` (``nccl`` on CUDA,
  ``gloo`` on the CPU): :func:`maybe_init_distributed`, :func:`world`,
  :func:`rank_device`, :func:`process_shard`, and the collectives with
  gradients the trainer needs (:func:`all_gather`, :func:`all_reduce_sum`).
  NCCL takes one rank per card, so two ranks need two cards; on one card
  the two-rank path runs on ``gloo`` over the CPU.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Iterable, List, Optional, Tuple

import torch
import torch.distributed as dist

from nafp_tpu_torch.device import DeviceLike, resolve_device


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world() -> Tuple[int, int]:
    """(rank, world size) of the process group; (0, 1) without one."""
    if not _initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def maybe_init_distributed(cfg: Optional[Dict[str, Any]] = None,
                           device: DeviceLike = None) -> bool:
    """Join a ``torch.distributed`` process group; a no-op without a
    coordinator.

    Sources, in order (the JAX package's contract):
      1. env ``NAFP_COORDINATOR`` (host:port), ``NAFP_NUM_PROCESSES``,
         ``NAFP_PROCESS_ID``;
      2. ``cfg['DEVICE']['MULTIHOST']`` = ``{COORDINATOR, NUM_PROCESSES,
         PROCESS_ID}``.

    The group is initialised over ``tcp://COORDINATOR`` with ``nccl`` when
    ``device`` is a CUDA device (``cuda:0`` by default) and ``gloo`` on the
    CPU. Returns True when a group is up (a second call is a no-op)."""
    if _initialized():
        return True
    coord = os.environ.get("NAFP_COORDINATOR")
    nproc = os.environ.get("NAFP_NUM_PROCESSES")
    pid = os.environ.get("NAFP_PROCESS_ID")
    if not coord and cfg:
        mh = (cfg.get("DEVICE") or {}).get("MULTIHOST") or {}
        coord = mh.get("COORDINATOR")
        nproc = mh.get("NUM_PROCESSES")
        pid = mh.get("PROCESS_ID")
    if not coord:
        return False
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coord}",
                            world_size=int(nproc), rank=int(pid))
    return True


def local_rank() -> int:
    """This process's card on its host: ``LOCAL_RANK`` from the
    environment when set, else the rank modulo the local card count."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    rank, _ = world()
    return rank % max(1, torch.cuda.device_count())


def rank_device(device: DeviceLike = None) -> torch.device:
    """The device of this rank: ``cuda:{local_rank()}`` for a CUDA run in a
    process group, else ``device`` (``cuda:0`` by default)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and _initialized():
        dev = resolve_device(torch.device("cuda", local_rank()))
        torch.cuda.set_device(dev)
    return dev


def process_shard(items: Iterable) -> List:
    """This process's round-robin share of a host-side work list (song
    files): by rank over the world size when a ``torch.distributed``
    process group is up, the whole list otherwise."""
    items = list(items)
    rank, size = world()
    return items[rank::size]


def local_devices(device: DeviceLike = None) -> List[torch.device]:
    """Every card of this host for a CUDA ``device`` (``cuda:0`` by
    default), ``[cpu]`` for the CPU."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def data_devices(cfg: Optional[Dict[str, Any]] = None,
                 device: DeviceLike = None) -> List[torch.device]:
    """The devices of one process's data-parallel pass
    (``DEVICE.MESH_DATA_PARALLEL``; the JAX package's ``mesh_from_cfg``).

    n <= 0 (the default -1): every local card, or ``[cpu]``. n > 0 on a
    card: the first n cards, and more than the host has raises. n > 0 on
    the CPU: the CPU n times (the test form of a multi-device pass)."""
    n = int(((cfg or {}).get("DEVICE") or {}).get("MESH_DATA_PARALLEL", -1)
            or -1)
    devs = local_devices(device)
    if n <= 0:
        return devs
    if devs[0].type != "cuda":
        return devs * n
    if n > len(devs):
        raise ValueError(f"DEVICE.MESH_DATA_PARALLEL {n} exceeds the "
                         f"{len(devs)} local CUDA devices")
    return devs[:n]


# ---------------------------------------------------------------------------
# Collectives with gradients
# ---------------------------------------------------------------------------
class _AllGather(torch.autograd.Function):
    """Rows of every rank, concatenated in rank order. Backward: the
    cotangent summed over ranks, this rank's rows kept (the transpose of
    ``jax.lax.all_gather``)."""

    @staticmethod
    def forward(ctx, x):
        _, size = world()
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x.contiguous())
        ctx.rows = x.shape[0]
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        rank, _ = world()
        g = g.contiguous().clone()
        dist.all_reduce(g)
        return g[rank * ctx.rows:(rank + 1) * ctx.rows]


class _AllReduceSum(torch.autograd.Function):
    """The sum over ranks. Backward: the cotangent summed over ranks (every
    rank's share of the loss depends on the sum)."""

    @staticmethod
    def forward(ctx, x):
        y = x.contiguous().clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g)
        return g


def all_gather(x: torch.Tensor) -> torch.Tensor:
    """(world·n, ...) rows of every rank, in rank order, with gradient;
    ``x`` itself without a process group of more than one rank."""
    return _AllGather.apply(x) if world()[1] > 1 else x


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over ranks, with gradient; ``x`` itself without a
    process group of more than one rank."""
    return _AllReduceSum.apply(x) if world()[1] > 1 else x


def all_reduce_(x: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """In place, no gradient: ``x`` reduced over ranks with ``op`` ('sum',
    'max' or 'min'); untouched without a process group of more than one
    rank. Returns ``x``."""
    if world()[1] > 1:
        dist.all_reduce(x, {"sum": dist.ReduceOp.SUM,
                            "max": dist.ReduceOp.MAX,
                            "min": dist.ReduceOp.MIN}[op])
    return x
