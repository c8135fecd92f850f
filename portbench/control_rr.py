"""Readings of the IVF-PQ re-rank cell's checks at the cell's own size, for
setting its limits. Controls of the refine, one precision below what the
port runs (``runners/query_pq_rr.py``): ``rr_tf32``, the refine's product
in TF32; ``rr_none``, the shortlist's first k in PQ order, not
re-scored. And ``port``, the port as it runs. Each run prints one JSON
line of the numbers the cell compares; the limits in
``workloads/<cell>.json`` are set between the port's readings and the
controls'. ``control_pq.py``'s controls of the PQ stage run on this cell
too (``--workload ivfpq-rr-icassp --control pq_fp8``).

    python3 -m portbench.control_rr --workload ivfpq-rr-icassp
        --control port|rr_tf32|rr_none --seeds N,N,... [--seconds S]

The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys

from portbench import registry, run
from portbench.runners.query_pq_rr import RR_CONTROLS

KINDS = ("port",) + RR_CONTROLS


def reading(cell, seed: int, kind: str, seconds: float, device, sizes=None):
    """The numbers ``cell`` compares, for one seed of ``kind`` (``sizes``:
    a smaller cell, for the CPU tests)."""
    if kind not in KINDS:
        raise ValueError(kind)
    kw = {"control": None if kind == "port" else kind, "sizes": sizes}
    return run.measure(cell, seed, seconds, False, device, kw)["checks"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--control", required=True, choices=KINDS)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    run.set_cache_dirs()
    import torch
    cell = registry.Cell(registry.benchmark(), args.workload)
    dev = torch.device("cuda", 0)
    for seed in map(int, args.seeds.split(",")):
        checks = reading(cell, seed, args.control, args.seconds, dev)
        print(json.dumps({"workload": args.workload,
                          "control": args.control, "seed": seed,
                          "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
