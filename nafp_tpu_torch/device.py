"""Device resolution and memory budgets.

Counterpart of ``nafp_tpu/utils/device.py``. The port runs on ``cuda:0``
unless the caller asks for the CPU; a missing card is an error, never a
quiet move to the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

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
    array: ``frac`` of the free device memory that
    ``torch.cuda.mem_get_info`` reports, so the index store, gather
    transients and search blocks keep the rest; ``fallback`` on the CPU.
    ``free_bytes`` injects a reading for tests."""
    if free_bytes is None:
        if device.type != "cuda":
            return fallback
        free_bytes, _ = torch.cuda.mem_get_info(device)
    return max(0, int(free_bytes * frac))
