"""Profiling and throughput observability.

Counterpart of ``nafp_tpu/utils/profiling.py``:
  - ``trace(dir)``: context manager around ``torch.profiler`` (host and,
    when the run is on the card, CUDA activity) that writes a Chrome trace
    into ``dir`` (training enables it with ``TRAIN.PROFILE_DIR``);
  - ``StepTimer``: wall-clock EMA of step time and items/s, the
    segments/s counter the trainer logs.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{time.strftime('%Y%m%d-%H%M%S')}.json"))


class StepTimer:
    """EMA step timer; call ``tick()`` once per step."""

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self._last: Optional[float] = None
        self.ema_dt: Optional[float] = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            dt = now - self._last
            self.ema_dt = (dt if self.ema_dt is None
                           else self.alpha * dt + (1 - self.alpha) * self.ema_dt)
        self._last = now

    @property
    def step_ms(self) -> float:
        return 1000.0 * (self.ema_dt or float("nan"))

    def items_per_sec(self, n_items: int) -> float:
        return n_items / self.ema_dt if self.ema_dt else float("nan")
