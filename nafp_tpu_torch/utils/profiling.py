"""Profiling and observability.

Counterpart of ``nafp_tpu/utils/profiling.py``:
  - ``trace(dir)``: context manager around ``torch.profiler`` (host and,
    when the run is on the card, CUDA activity) that writes a Chrome trace
    into ``dir`` (training enables it with ``TRAIN.PROFILE_DIR``);
  - ``span(name, device=False)``, ``spanned(name)``, ``count(name, n)``,
    ``snapshot()``, ``reset()``: the port's own spans and counters at its
    layer boundaries (the query protocol, the indexes, ``generate`` and
    its loader, the train step). They record exactly while a
    ``torch.profiler`` records in the calling thread, and cost one flag
    check otherwise: there is no switch of their own. A span opens a
    ``record_function`` range, so it lies on the profiler's clock and
    names the device's idle time beneath it, and adds its host seconds
    to a total by name. With ``device=True`` it also records a CUDA
    event on the current stream at entry and exit; ``snapshot()`` turns
    them into the stream time between the span's boundaries, which
    holds the device's idle time inside the span as well as its
    kernels. Nothing here synchronises the device on the program's path
    or changes what it computes;
  - ``device_profile(fn)``: one call under ``torch.profiler`` on the card,
    summarised as wall time, device busy time and device time by kernel
    (``chip_smoke.py``, ``extras/profile_evaluate.py``).
"""
from __future__ import annotations

import collections
import contextlib
import functools
import os
import threading
import time
from typing import Any, Callable, Dict, Iterator, Optional

import torch

# True while a torch.profiler records in the calling thread (the flag is
# thread-local: a worker thread reads False)
recording: Callable[[], bool] = torch._C._autograd._profiler_enabled


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


class _Total:
    """One span name's totals; ``pending`` holds its (start, end) CUDA
    events whose device time is not yet read."""
    __slots__ = ("n", "total_s", "device_s", "pending")

    def __init__(self):
        self.n, self.total_s = 0, 0.0
        self.device_s: Optional[float] = None
        self.pending: collections.deque = collections.deque()

    def resolve(self, wait: bool) -> None:
        """Add the device time of the pending pairs whose end has passed
        (with ``wait``, of every pair, waiting for each end event)."""
        while self.pending:
            start, end = self.pending[0]
            if wait:
                end.synchronize()
            elif not end.query():
                return
            self.pending.popleft()
            self.device_s = (self.device_s or 0.0) \
                + start.elapsed_time(end) / 1e3


class Tracer:
    """Totals of spans and counters by name, for every thread that
    records; one per process (``TRACER``)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._spans: Dict[str, _Total] = {}
        self._counts: Dict[str, float] = {}

    def add_span(self, name: str, dur: float, events=None) -> None:
        with self._lock:
            t = self._spans.get(name)
            if t is None:
                t = self._spans[name] = _Total()
            t.n += 1
            t.total_s += dur
            if events is not None:
                t.pending.append(events)
                # memory stays bounded by how far the host runs ahead
                t.resolve(wait=False)

    def count(self, name: str, n: float = 1) -> None:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + n

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """``{"spans": {name: {"n", "total_s", "device_s"}},
        "counts": {name: value}}`` since the last ``reset``; ``device_s``
        is None for a span that recorded no device events. Waits for the
        device to pass the recorded events."""
        with self._lock:
            spans = {}
            for name, t in self._spans.items():
                t.resolve(wait=True)
                spans[name] = {"n": t.n, "total_s": t.total_s,
                               "device_s": t.device_s}
            return {"spans": spans, "counts": dict(self._counts)}

    def reset(self) -> None:
        with self._lock:
            self._spans.clear()
            self._counts.clear()


TRACER = Tracer()


class _Off:
    """The span every call shares while nothing records."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "device", "rf", "start", "events")

    def __init__(self, name: str, device: bool):
        self.name = name
        self.device = device and torch.cuda.is_available()

    def __enter__(self):
        self.rf = torch.autograd.profiler.record_function(self.name)
        self.rf.__enter__()
        self.events = None
        if self.device:
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter() - self.start
        if self.events is not None:
            self.events[1].record()
        self.rf.__exit__(*exc)
        TRACER.add_span(self.name, dur, self.events)
        return False


def span(name: str, device: bool = False):
    """A context manager that adds its time to ``name``'s totals while a
    profiler records in this thread, and does nothing otherwise.
    ``device``: the work inside runs on the card's current stream; the
    stream time between the span's boundaries is recorded too."""
    if not recording():
        return _OFF
    return _Span(name, device)


def spanned(name: str):
    """Decorator: every call of the function inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, n: float = 1) -> None:
    """Add ``n`` to counter ``name`` while a profiler records in this
    thread."""
    if recording():
        TRACER.count(name, n)


def snapshot() -> Dict[str, Dict[str, Any]]:
    """The process's totals (``Tracer.snapshot``)."""
    return TRACER.snapshot()


def reset() -> None:
    """Clear the process's totals."""
    TRACER.reset()


# profiler activity types of what the device itself runs; user
# annotations mirrored onto the device's timeline are no device work
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")


def _device_work(e) -> bool:
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return kind() in DEVICE_WORK
    return not e.is_user_annotation()


def device_summary(events, wall_ms: float) -> Dict[str, object]:
    """Device busy time (the union of kernel, copy and memset intervals)
    and, per device operation name, (ms, count), largest first, of the
    profiler's raw events."""
    from torch.autograd import DeviceType

    spans, by_name = [], {}
    for e in events:
        if e.device_type() != DeviceType.CUDA or not _device_work(e):
            continue
        name = e.name()
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


def device_profile(fn: Callable[[], object]) -> Dict[str, object]:
    """Run ``fn`` once under ``torch.profiler`` on the card: the wall time
    (profiler on) and ``device_summary`` of its events. Reads the raw
    trace events: turning the ~1M host events of an IVF-PQ build into
    ``prof.events()`` takes minutes."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return device_summary(prof.profiler.kineto_results.events(), wall_ms)
