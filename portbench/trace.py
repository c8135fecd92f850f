"""Device time from a ``torch.profiler`` trace of the measured window.

The busy-interval union is the benchmark's frozen copy of the port's
``utils/profiling.device_profile`` arithmetic: the device is busy while any
of its kernel, copy or memset intervals runs, and each operation's time is
summed by name. Unlike that copy, it leaves out the user annotations the
profiler mirrors onto the device's timeline, which are no device work. It reads the profiler's raw events: building
``prof.events()`` from a window of a million host events takes minutes.
Idle gaps are the holes between the busy intervals, each named by what the
host was doing across it (the innermost host event that covers its middle,
under the innermost benchmark span, ``pb.*``, that covers it).
"""
from __future__ import annotations

import bisect
from typing import Any, Dict, List, Tuple

TOP = 10
# what the device itself runs; user annotations mirrored onto the device
# timeline (``record_function`` ranges) are not device work
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")


def _union(spans: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _covering(events: List[Tuple[int, int, str]], starts: List[int],
              t: int, lookback: int) -> str:
    """Name of the shortest of ``events`` (sorted by start) that covers
    time ``t``, among the ``lookback`` that began last before it; ''
    when none does."""
    best, best_len = "", None
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 1 - lookback), -1):
        a, b, name = events[j]
        if b >= t and (best_len is None or b - a < best_len):
            best, best_len = name, b - a
    return best


def _device_work(e) -> bool:
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return kind() in DEVICE_WORK
    return not e.is_user_annotation()


def read(prof) -> Dict[str, Any]:
    """Summarise a finished profile: device busy seconds, device time by
    operation name, and the longest idle gaps with their host names."""
    from torch.autograd import DeviceType

    dev_spans: List[Tuple[int, int]] = []
    by_name: Dict[str, float] = {}
    host: List[Tuple[int, int, str]] = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start, dur = e.start_ns(), e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if not _device_work(e):
                continue
            dev_spans.append((start, start + dur))
            by_name[name] = by_name.get(name, 0.0) + dur / 1e9
        elif e.device_type() == DeviceType.CPU:
            host.append((start, start + dur, name))
    busy = _union(dev_spans)
    busy_s = sum(b - a for a, b in busy) / 1e9
    gaps = sorted(((busy[i + 1][0] - busy[i][1], busy[i][1],
                    busy[i + 1][0]) for i in range(len(busy) - 1)),
                  reverse=True)[:TOP]
    # the profiler's own buffer requests name no work of the host
    ops_h = sorted(h for h in host if not h[2].startswith(("pb.",
                                                          "Activity")))
    spans_h = sorted(h for h in host if h[2].startswith("pb."))
    ops_s, spans_s = [h[0] for h in ops_h], [h[0] for h in spans_h]
    idle = []
    for length, a, b in gaps:
        mid = (a + b) // 2
        inner = _covering(ops_h, ops_s, mid, 20000) or "no host op"
        span = _covering(spans_h, spans_s, mid, len(spans_h))
        idle.append([f"{inner} | {span}" if span else inner, length / 1e9])
    ops = sorted(by_name.items(), key=lambda r: -r[1])
    return {"busy_s": busy_s, "kernel_s": by_name,
            "device_ops": [[n, s] for n, s in ops[:TOP]],
            "idle_gaps": idle}
