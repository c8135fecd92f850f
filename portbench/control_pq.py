"""Readings of the IVF-PQ cell's checks at the cell's own size, for
setting its limits. Controls, one precision below what the port runs:
``pq_int8``, the port's own int8-codebook decode
(``IVFPQIndex(decode_int8=True)``: each codeword rounded to int8 with an
f32 scale per subquantizer and dimension) in place of the f32 codebooks
it decodes from; ``pq_fp8``, each decoded chunk rounded to float8 e4m3 in
place of the bf16 rows B3 scans. Planted build faults: ``kmeans1``, the
k-means of the lists and of the books stopped after one Lloyd step;
``raw_books``, the books trained on the rows' own subvectors in place of
their residuals. And ``port``, the port as it runs. Each run prints one
JSON line of the numbers the cell compares; the limits in
``workloads/<cell>.json`` are set between the port's readings and the
others'.

    python3 -m portbench.control_pq --workload ivfpq-icassp
        --control port|pq_int8|pq_fp8|kmeans1|raw_books --seeds N,N,...
        [--seconds S]

The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys

from portbench import registry, run

CONTROLS = ("pq_int8", "pq_fp8")
FAULTS = ("kmeans1", "raw_books")
KINDS = ("port",) + CONTROLS + FAULTS


@contextlib.contextmanager
def planted(fault):
    """``IVFPQIndex.train`` with the build fault ``fault`` (one of
    ``FAULTS``) for the duration."""
    import numpy as np
    import torch
    from nafp_tpu_torch.search import index as P

    plain = P.IVFPQIndex.train

    def train(self, data, max_train=int(1e7), kmeans_iters=10, seed=0):
        if fault == "kmeans1":
            return plain(self, data, max_train, 1, seed)
        plain(self, data, max_train, kmeans_iters, seed)
        x = torch.from_numpy(np.ascontiguousarray(data, np.float32)).to(
            self.device).view(-1, self.m, self.dsub)
        self.codebooks = torch.stack([
            P.kmeans(x[:, mi].contiguous(), self.ksub, iters=kmeans_iters,
                     seed=seed + 1 + mi) for mi in range(self.m)])
        self._books_q_cache = None

    if fault not in FAULTS:
        raise ValueError(fault)
    P.IVFPQIndex.train = train
    try:
        yield
    finally:
        P.IVFPQIndex.train = plain


def reading(cell, seed: int, kind: str, seconds: float, device, sizes=None):
    """The numbers ``cell`` compares, for one seed of ``kind`` (``sizes``:
    a smaller cell, for the CPU tests)."""
    if kind not in KINDS:
        raise ValueError(kind)
    kw = {"control": kind if kind in CONTROLS else None, "sizes": sizes}
    with planted(kind) if kind in FAULTS else contextlib.nullcontext():
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
