"""Device resolution and memory budgets.

Counterpart of ``nafp_tpu/utils/device.py``. The port runs on ``cuda:0``
unless the caller asks for the CPU; a missing card is an error, never a
quiet move to the CPU.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]


def set_f32_precision() -> None:
    """Full-f32 products and convolutions on the card.

    The JAX frontend pins HIGH matmul precision (ops/melspec.py there);
    TF32 keeps fewer bits than that, and cuDNN applies it to f32
    convolutions by default. Every f32 path of the port runs with both
    switches off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: DeviceLike = None,
                   nogpu: bool = False) -> torch.device:
    """The device to run on: ``device`` when given, the CPU for ``nogpu``,
    else ``cuda:0``. Raises when a CUDA device is asked for (explicitly or
    by default) and none is present."""
    if nogpu:
        dev = torch.device("cpu")
    elif device is None:
        dev = torch.device("cuda", 0)
    else:
        dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device found: nafp_tpu_torch runs on the GPU unless "
                "asked for the CPU (pass --nogpu, or device='cpu')")
        if dev.index is None:
            dev = torch.device("cuda", 0)
        set_f32_precision()
    return dev


def device_recon_budget(device: torch.device,
                        fallback: int = 4 << 30, frac: float = 0.5,
                        free_bytes: Optional[int] = None) -> int:
    """Bytes it is safe to spend on the evaluation's device-resident recon
    array: ``frac`` of the free device memory, so the index store, gather
    transients and search blocks keep the rest; ``fallback`` on the CPU.
    Free is what ``torch.cuda.mem_get_info`` reports plus what PyTorch's
    caching allocator holds without a tensor in it (an index build leaves
    gigabytes there, which the allocator hands out again). ``free_bytes``
    injects a reading for tests."""
    if free_bytes is None:
        if device.type != "cuda":
            return fallback
        free_bytes = (torch.cuda.mem_get_info(device)[0]
                      + torch.cuda.memory_reserved(device)
                      - torch.cuda.memory_allocated(device))
    return max(0, int(free_bytes * frac))


def chunked_device_put(arr: np.ndarray, device: DeviceLike = None,
                       dtype: Optional[np.dtype] = None,
                       chunk_bytes: int = 128 << 20,
                       visit: Optional[Callable[[int, np.ndarray], None]]
                       = None) -> torch.Tensor:
    """Upload a host array (a disk memmap too) in bounded row chunks.

    Counterpart of ``chunked_device_put`` in ``nafp_tpu/utils/device.py``.
    The device tensor is allocated once; rows are read straight off
    ``arr`` into one of two reused staging buffers (pinned on the card),
    each copied up without blocking while the other is filled, so no full
    host copy of ``arr`` is ever made. ``dtype`` converts on the way (the
    staging buffers hold it). ``visit(start, block)`` sees every staged
    host block, in order, before its copy starts: one read of the source
    serves the upload and a host reduction. ``device``: ``cuda:0`` by
    default; raises when no card is present."""
    dev = resolve_device(device)
    dt = np.dtype(arr.dtype if dtype is None else dtype)
    n = arr.shape[0]
    row_bytes = int(np.prod(arr.shape[1:], dtype=np.int64)) * dt.itemsize
    rows = max(1, min(n, chunk_bytes // max(1, row_bytes)))
    tdt = torch.from_numpy(np.empty(0, dt)).dtype
    out = torch.empty(arr.shape, dtype=tdt, device=dev)
    pinned = dev.type == "cuda"
    stages = [torch.empty((rows,) + tuple(arr.shape[1:]), dtype=tdt,
                          pin_memory=pinned) for _ in range(2 if n > rows
                                                            else 1)]
    events = [torch.cuda.Event() if pinned else None for _ in stages]
    for j, s in enumerate(range(0, n, rows)):
        e = min(s + rows, n)
        slot = j % len(stages)
        if pinned and j >= len(stages):
            events[slot].synchronize()    # its previous copy has landed
        blk = stages[slot][:e - s]
        blk.numpy()[...] = arr[s:e]
        if visit is not None:
            visit(s, blk.numpy())
        out[s:e].copy_(blk, non_blocking=pinned)
        if pinned:
            events[slot].record()
    if pinned:
        torch.cuda.current_stream(dev).synchronize()   # staging freed
    return out


def device_memory_stats(device: DeviceLike = None) -> List[Dict]:
    """Memory of every CUDA device as ``{id, platform, kind, bytes_in_use,
    peak_bytes_in_use, bytes_limit}``: bytes the caching allocator holds in
    tensors now and at its peak (``torch.cuda.memory_stats``), and the
    card's total (``torch.cuda.mem_get_info``). Counterpart of
    ``device_memory_stats`` in ``nafp_tpu/utils/device.py``. For the CPU
    (``device='cpu'``) the empty form: one record of platform 'cpu' whose
    byte fields are None."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return [{"id": 0, "platform": "cpu", "kind": "cpu",
                 "bytes_in_use": None, "peak_bytes_in_use": None,
                 "bytes_limit": None}]
    out = []
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        _, total = torch.cuda.mem_get_info(i)
        out.append({"id": i, "platform": "gpu",
                    "kind": torch.cuda.get_device_name(i),
                    "bytes_in_use": stats.get("allocated_bytes.all.current",
                                              0),
                    "peak_bytes_in_use": stats.get(
                        "allocated_bytes.all.peak", 0),
                    "bytes_limit": total})
    return out
