"""Time the port's top-k kernels in one checkout, for an A/B of two commits
on one card.

Builds the CUDA kernels of the checkout at ``--tree`` (its own
``nafp_tpu_torch`` package, imported from there), then times, with CUDA
events on data made on the card from seed 0: B1 (Bq 512 x 619,500 f32, k
20 and 80), B2 (Bq 1024 x 620,544 int8, k 20 and 80; Bq 512 x 8,388,608, the sq8
bench's shape), B3 (the IVF-PQ protocol store of
``extras/sweep_b3_grid.py``, k 20 and 80) and B4b (both shapes, and B2's
at d 256, its K-extent-256 instance). It prints
one line ``AB {...}`` with the checkout's name, the build's seconds, the
times in ms and each library's ptxas registers and spills. With
``--main-path`` it instead drives that checkout's ``chip_smoke.py`` main
path (generate, then evaluate ``-i l2``, ``sq8``, ``ivfpq``, ``ivfpq-rr``
over 619,500 rows, in the checkout's ``smoke_run/``) and prints one line
``AB_MAIN {...}`` with each evaluate's ms/query, index build seconds and
kernel launches. Run it on the card by path, one process per checkout, in
turns (parent, change, change, parent)::

    python nafp_tpu_torch/extras/ab_kernels.py --tree abrun/parent
    python nafp_tpu_torch/extras/ab_kernels.py --tree .

It uses only entry points that every checkout of the port since its
sq8 bench and B3 sweep has (``topk_ip``, ``topk_ip_sq8``,
``topk_ip_masked``, ``run_dotonly``, ``make_data``, ``make_store``,
``chip_smoke.phase_main_path``).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python nafp_tpu_torch/extras/ab_kernels.py",
        description="Time B1-B4b of one checkout of the port.")
    ap.add_argument("--tree", required=True,
                    help="root of the checkout whose kernels to time")
    ap.add_argument("--main-path", action="store_true",
                    help="time the checkout's evaluate runs instead")
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch
    from nafp_tpu_torch import kernels
    from nafp_tpu_torch.extras import bench_sq8_kernel as B
    from nafp_tpu_torch.extras.sweep_b3_grid import make_store, time_ms
    from nafp_tpu_torch.search import topk as T
    if os.path.dirname(os.path.dirname(os.path.abspath(kernels.__file__))) \
            != tree:
        raise RuntimeError(f"nafp_tpu_torch imported from {kernels.__file__}"
                           f", not from {tree}")
    secs, logs = kernels.build_all()
    regs = {}
    for name, text in logs.items():
        lines = text.splitlines()
        regs[name] = [ln.split("Used")[1].split(",")[0].strip()
                      for ln in lines if "Used" in ln]
        regs[name + " spills"] = [
            ln.strip() for ln in lines if "spill" in ln
            and "0 bytes spill stores, 0 bytes spill loads" not in ln]
    dev = torch.device("cuda", 0)
    if args.main_path:
        import shutil
        import chip_smoke as S
        if os.path.dirname(os.path.abspath(S.__file__)) != tree:
            raise RuntimeError(f"chip_smoke imported from {S.__file__}")
        shutil.rmtree(S.WORK, ignore_errors=True)
        os.makedirs(S.WORK)
        r = S.phase_main_path(dev)
        out = dict(tree=os.path.basename(tree), device=torch.cuda.
                   get_device_name(dev), ms_per_query=r["ms_per_query"],
                   build_sec=r["build_sec"], launches=r["launches"])
        print("AB_MAIN " + json.dumps(out), flush=True)
        return out
    gen = torch.Generator(device=dev).manual_seed(0)

    def unit(n, d=128):
        x = torch.randn(n, d, generator=gen, device=dev)
        return x / x.norm(dim=1, keepdim=True)

    ms = {}
    db, q = unit(619_500), unit(512)
    ms["b1"] = time_ms(lambda: T.topk_ip(q, db, 20))
    ms["b1_k80"] = time_ms(lambda: T.topk_ip(q, db, 80))
    del db
    x = unit(620_544)
    sc = x.abs().amax(dim=1) / 127
    v8 = torch.round(x / sc[:, None]).clamp(-127, 127).to(
        torch.int8).contiguous()
    rm = torch.zeros(620_544, device=dev)
    del x
    q = unit(1024)
    for k in (20, 80):
        ms[f"b2_k{k}"] = time_ms(lambda: T.topk_ip_sq8(q, v8, sc, rm, k))
    ms["b4b_b2_shape"] = time_ms(lambda: B.run_dotonly(q, v8, sc, rm))
    del v8
    x = unit(620_544, 256)
    sc = x.abs().amax(dim=1) / 127
    v8 = torch.round(x / sc[:, None]).clamp(-127, 127).to(
        torch.int8).contiguous()
    del x
    q = unit(1024, 256)
    ms["b4b_b2_shape_d256"] = time_ms(lambda: B.run_dotonly(q, v8, sc, rm))
    del v8
    qm, dbm, ids, bias = make_store(0, dev)
    for k in (20, 80):
        ms[f"b3_k{k}"] = time_ms(lambda: T.topk_ip_masked(
            qm, dbm, ids, bias, k, 128))
    del dbm
    qb, vb, sb, rb = B.make_data(8_388_608, 512, dev)
    ms["b4b_bench"] = time_ms(lambda: B.run_dotonly(qb, vb, sb, rb), 10)
    ms["b2_bench"] = time_ms(lambda: T.topk_ip_sq8(qb, vb, sb, rb, 20), 10)
    out = dict(tree=os.path.basename(tree), device=torch.cuda.get_device_name(
        dev), build_s=round(secs, 2), ms=ms, regs=regs)
    print("AB " + json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
