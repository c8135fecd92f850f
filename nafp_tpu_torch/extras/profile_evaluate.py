#!/usr/bin/env python
"""One ``evaluate`` under ``torch.profiler`` on the card: where its device
time goes, and how much of it the top-k kernels take.

    python -m nafp_tpu_torch.extras.profile_evaluate OUT.json -- \\
        evaluate NAME INDEX -c CONFIG -i TYPE -t icassp

Runs the CLI command after ``--`` in this process with the kernels' launch
counters zeroed, and writes OUT.json: the card (name, power limit), the
wall time with the profiler on, the device's busy time and share, the
launches per kernel, the device time of the top-k kernels (B1
``topk_f32.cu``, B2 ``sq8_scan.cuh``, B3 ``topk_masked.cu``: their scan and
merge kernels; one evaluate runs one of them) and the ten device
operations that take most time. Needs a CUDA card.
"""
from __future__ import annotations

import json
import subprocess
import sys

import torch

# device operation names of the hand-written top-k kernels' launches
KERNEL_NAMES = ("scan_kernel", "merge_kernel")


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) < 3 or argv[1] != "--":
        raise SystemExit(__doc__)
    out, cmd = argv[0], argv[2:]
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this profile is of the card")
    from nafp_tpu_torch import kernels
    from nafp_tpu_torch.cli import main as cli
    from nafp_tpu_torch.search import topk as T
    from nafp_tpu_torch.utils.profiling import device_profile

    kernels.build_all()
    T.reset_launches()
    prof = device_profile(lambda: cli(cmd, standalone_mode=False))
    topk = {n: v for n, v in prof["by_name"].items()
            if any(k in n for k in KERNEL_NAMES)}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    rec = dict(command=cmd, card=smi, wall_ms=prof["wall_ms"],
               device_busy_ms=prof["device_busy_ms"], busy=prof["busy"],
               launches=dict(T.LAUNCHES),
               topk_kernel_ms=sum(ms for ms, _ in topk.values()),
               topk_kernel_ops=sum(n for _, n in topk.values()),
               top=[dict(name=n[:90], ms=ms, count=c) for n, (ms, c) in
                    list(prof["by_name"].items())[:10]])
    with open(out, "w") as f:
        json.dump(rec, f, indent=1)
    print("PROFILE " + json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
