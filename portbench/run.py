"""Run one cell of the port's benchmark once and print its result line.

    python3 -m portbench.run --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout. The run builds the cell (weights, data and
index from ``--seed``, every shape warmed up), measures for ``--seconds``
(the unit of work running when they end runs to its end, and the window
holds it), compares what the window produced with the plain reference, and
prints one JSON line last on standard output:

    {"correct", "attempted", "failed", "metrics", "device"[, "breakdown"],
     "checks"}

``metrics`` are the cell's end-to-end metrics with ``--trace 0`` and its
per-layer metrics, read from a ``torch.profiler`` trace of the window,
with ``--trace 1``. ``checks`` gives each compared number beside its limit;
they are also the last lines on standard error. The run exits non-zero,
with no result, when the card or the port is missing, or when ``jax``,
``jaxlib``, ``flax`` or ``nafp_tpu`` is loaded once the window has closed.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import importlib
import json
import os
import subprocess
import sys
import time
from typing import Any, Dict, Iterator, List, Optional

from portbench import registry

FORBIDDEN = ("jax", "jaxlib", "flax", "nafp_tpu")


def since_process_start() -> float:
    """Seconds since this process started (kernel clock ticks)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    with open("/proc/uptime") as f:
        return float(f.read().split()[0]) - start


def set_cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port's CUDA libraries are built into its own ``_build/``)."""
    base = os.path.join(registry.WORK, "cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = os.path.join(base, sub)
    os.environ["USE_FLAX"] = "0"       # no JAX from libraries either


class Window:
    """The measured window: its start, spans of the benchmark's own code
    around calls into the program (host clock; under the profiler also
    ``pb.<name>`` annotations), and counters."""

    def __init__(self, traced: bool):
        self.traced = traced
        self.t0: Optional[float] = None
        self.setup_s: Optional[float] = None
        self.t1: Optional[float] = None
        self.spans: Dict[str, float] = {}
        self.counts: Dict[str, Any] = {}

    def start(self) -> None:
        self.setup_s = since_process_start()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        self.t1 = time.perf_counter()

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        if self.traced:
            from torch.profiler import record_function
            cm = record_function(f"pb.{name}")
        else:
            cm = contextlib.nullcontext()
        t = time.perf_counter()
        with cm:
            yield
        self.spans[name] = self.spans.get(name, 0.0) + time.perf_counter() - t

    def count(self, name: str, n: Any = 1) -> None:
        self.counts[name] = self.counts.get(name, 0) + n


class Context:
    """What a per-layer metric reader sees."""

    def __init__(self, kind, window: Window, trace, work):
        self.kind = kind
        self.window_s = window.seconds
        self.spans = window.spans
        self.counts = window.counts
        self.trace = trace
        self.work = work


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else None


def forbidden_modules(names: Optional[List[str]] = None) -> List[str]:
    """The forbidden top-level names among ``names`` (default: every
    loaded module), each compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".", 1)[0] for m in names} & set(FORBIDDEN))


def runner_class(cell: registry.Cell):
    mod = importlib.import_module(f"portbench.runners.{cell.traffic['runner']}")
    return mod.Runner


def measure(cell: registry.Cell, seed: int, seconds: float, traced: bool,
            device, runner_kwargs: Optional[Dict[str, Any]] = None
            ) -> Dict[str, Any]:
    """Set up, measure and check one run of ``cell`` on ``device``; the
    result line as a dict (``correct`` False where a check fails)."""
    import torch

    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats()
    drv = runner_class(cell)(cell, seed, device, **(runner_kwargs or {}))
    drv.setup()
    win = Window(traced)
    trace = None
    if traced:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if on_card else [])
        with profile(activities=acts) as prof:
            drv.window(seconds, win)
        from portbench import trace as trace_mod
        trace = trace_mod.read(prof)
        del prof
    else:
        drv.window(seconds, win)
    peak_bytes = int(torch.cuda.max_memory_allocated()) if on_card else 0
    e2e = drv.end_to_end(win)
    e2e["setup_s"] = win.setup_s
    attempted = drv.attempted
    kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    work = drv.work()
    drv.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    checks = drv.check()
    correct = all(v <= cell.limits[n] for n, v in checks.items())

    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    metrics: Dict[str, Dict[str, Any]] = {}
    if traced:
        ctx = Context(kind, win, trace, work)
        for m in cell.per_layer:
            v = registry.metric_reader(m["name"], cell.base)(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": units[m["name"]]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]],
                                  "unit": units[m["name"]]}
    line: Dict[str, Any] = {
        "correct": bool(correct), "attempted": attempted, "failed": 0,
        "metrics": metrics,
        "device": {"platform": "gpu" if on_card else "cpu", "kind": kind,
                   "count": 1, "memory_peak_bytes": peak_bytes}}
    if traced:
        line["device"]["busy_s"] = trace["busy_s"]
        line["device"]["window_s"] = win.seconds
        line["breakdown"] = {"device_ops": trace["device_ops"],
                             "idle_gaps": trace["idle_gaps"]}
    if on_card:
        line["card"] = power_limit()
    line["checks"] = {n: {"value": v, "limit": cell.limits[n]}
                      for n, v in checks.items()}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_cache_dirs()
    cell = registry.Cell(registry.benchmark(), args.workload)

    import torch
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " found", file=sys.stderr)
        return 2
    line = measure(cell, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    for n, c in line["checks"].items():
        ok = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"check {n} {c['value']!r} limit {c['limit']!r} {ok}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
