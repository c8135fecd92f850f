"""Find the benchmark's files by the names ``BENCHMARK.json`` gives."""
from __future__ import annotations

import importlib.util
import json
import os
from typing import Any, Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# Caches and working files of a run: a fixed path inside the checkout,
# listed in the repository's .gitignore.
WORK = os.path.join(ROOT, ".portbench_work")


def _load_json(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def benchmark(path: Optional[str] = None) -> Dict[str, Any]:
    return _load_json(path or os.path.join(ROOT, "BENCHMARK.json"))


def _named(entries: List[Dict[str, Any]], name: str, what: str
           ) -> Dict[str, Any]:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names; the
    traffic, workload and metric files are looked up under ``base``."""

    def __init__(self, bench: Dict[str, Any], name: str, base: str = HERE):
        self.entry = _named(bench["workloads"], name, "workload")
        self.name, self.base = name, base
        cfg_entry = _named(bench["configs"], self.entry["config"],
                           "configuration")
        self.config = _load_json(os.path.join(ROOT, cfg_entry["file"]))
        self.traffic = traffic(self.entry["traffic"], base)
        self.limits = _load_json(os.path.join(
            base, "workloads", f"{name}.json"))["limits"]
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])
                          and m["moves"] in reported]


def traffic(name: str, base: str = HERE) -> Dict[str, Any]:
    return _load_json(os.path.join(base, "traffic", f"{name}.json"))


def metric_reader(name: str, base: str = HERE
                  ) -> Callable[[Any], Optional[float]]:
    """``read(ctx)`` of ``metrics/<name>.py`` (a file name may hold dots,
    so it is loaded by path)."""
    path = os.path.join(base, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics._{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
