"""Readings of a cell's controls and planted faults, at the cell's own size.

A control is the reference put in the port's place one precision below the
configuration's: the port's own one-byte activation path (``MODEL.
ACT_STORE`` int8 or fp8) for the bf16 encoder; a TF32 search and re-rank
for the exact f32 search; the reference train step in fp8 for the bf16
encoder under training. ``half`` plants the fault "half of the batch left
out, the loss taken over the rest" in the reference train step. Each run
prints one JSON line of the numbers the cell compares; the limits in
``workloads/<cell>.json`` are set between these readings and the port's.

    python3 -m portbench.control --workload NAME --control KIND
        --seeds N,N,... [--seconds S]

KIND: ``act_int8``, ``act_fp8``, ``tf32`` (query cells), ``fp8``,
``half`` (training cells). The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys

from portbench import registry, run

ACT = {"act_int8": "int8", "act_fp8": "fp8"}


def tf32_search(self, q, k, block=512):
    """The exact search's reference in TF32: blocked products and top-k."""
    import numpy as np
    import torch
    outs_d, outs_i = [], []
    for s in range(0, len(q), block):
        qt = torch.from_numpy(np.ascontiguousarray(q[s:s + block])).to(
            self.device)
        d, i = torch.topk(qt @ self.db.T, k, dim=1)
        outs_d.append(d.cpu().numpy())
        outs_i.append(i.int().cpu().numpy())
    return np.concatenate(outs_d), np.concatenate(outs_i)


def reading(cell, seed: int, kind: str, seconds: float, device,
            sizes=None):
    """The numbers ``cell`` compares, for one seed of control ``kind``
    (``sizes``: a smaller cell, for the CPU tests)."""
    import torch
    if kind in ACT:
        return run.measure(cell, seed, seconds, False, device,
                           {"port_model": {"ACT_STORE": ACT[kind]},
                            "sizes": sizes})["checks"]
    if kind == "tf32":
        from nafp_tpu_torch.search.index import FlatIndex
        plain = FlatIndex.search
        FlatIndex.search = tf32_search
        try:
            drv = run.runner_class(cell)(cell, seed, device, sizes=sizes)
            drv.setup()
            # after the set-up, whose calls into the port switch TF32 off
            torch.backends.cuda.matmul.allow_tf32 = True
            win = run.Window(False)
            drv.window(seconds, win)
            drv.release()
            return {k: {"value": v, "limit": cell.limits[k]}
                    for k, v in drv.check().items()}
        finally:
            FlatIndex.search = plain
    if kind in ("fp8", "half"):
        from portbench import weights
        from portbench.runners import train
        drv = train.Runner(cell, seed, device, sizes=sizes)
        drv.w0 = weights.make(drv.conf["model"], seed, device)
        drv._corpus()
        ref = drv.reference()
        ctl = drv.reference(**({"precision": "fp8"} if kind == "fp8"
                               else {"half": True}))
        got = train.compare(ctl["losses"], ctl["grad_norms"], ctl["change"],
                            ref)
        return {k: {"value": v, "limit": cell.limits[k]}
                for k, v in got.items()}
    raise ValueError(kind)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--control", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    run.set_cache_dirs()
    import torch
    cell = registry.Cell(registry.benchmark(), args.workload)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    for seed in map(int, args.seeds.split(",")):
        checks = reading(cell, seed, args.control, args.seconds, dev)
        print(json.dumps({"workload": args.workload, "control": args.control,
                          "seed": seed, "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
