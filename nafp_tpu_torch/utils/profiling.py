"""Profiling and throughput observability.

Counterpart of ``nafp_tpu/utils/profiling.py``:
  - ``trace(dir)``: context manager around ``torch.profiler`` (host and,
    when the run is on the card, CUDA activity) that writes a Chrome trace
    into ``dir`` (training enables it with ``TRAIN.PROFILE_DIR``);
  - ``StepTimer``: wall-clock EMA of step time and items/s, the
    segments/s counter the trainer logs;
  - ``device_profile(fn)``: one call under ``torch.profiler`` on the card,
    summarised as wall time, device busy time and device time by kernel
    (``chip_smoke.py``, ``extras/profile_evaluate.py``).
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, Iterator, Optional

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


def device_profile(fn: Callable[[], object]) -> Dict[str, object]:
    """Run ``fn`` once under ``torch.profiler`` on the card: the wall time
    (profiler on), the device's busy time (the union of its kernel and copy
    intervals) and, per device operation name, (ms, count), largest first.
    Reads the raw trace events: turning the ~1M host events of an IVF-PQ
    build into ``prof.events()`` takes minutes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, by_name = [], {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() != DeviceType.CUDA or name.startswith("Activity"):
            continue
        start, dur = e.start_ns(), e.duration_ns()
        spans.append((start, start + dur))
        ms, n = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + dur / 1e6, n + 1)
    busy_ns, end = 0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy_ns += b - max(a, end)
            end = b
    busy_ms = busy_ns / 1e6
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                busy=busy_ms / wall_ms,
                by_name=dict(sorted(by_name.items(), key=lambda r: -r[1][0])))
