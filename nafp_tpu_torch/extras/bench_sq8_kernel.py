"""Micro-benchmark of the sq8 full-scan kernel and its variants on the card:
kernels B4a and B4b, their wrappers and plain versions, and the entry point.

Counterpart of ``extras/bench_sq8_kernel.py``:

- ``run_variant`` (kernel B4a, ``csrc/bench_variant.cu``) replaces the TPU
  kernel of the same name: kernel B2's function (the exact top-k of
  ``(bf16(q) · row) · scale[row] + rmask[row]`` over an int8 store) with
  the bench's switches, on B2's sq8 scan (``csrc/sq8_scan.cuh``).
  ``merge_mode`` "v0"/"v3" is B2's warp merge (B2's own instance) and "v2"
  the reference's filter-then-drain merge, one warp per query;
  ``int8_dot`` quantises each query to int8 (scale ``max|q| / 127``),
  takes exact s8×s8→s32 products on the int8 tensor cores and multiplies
  the scores by the query's scale afterwards, as the reference does
  outside its kernel. ``scale_mode`` "bcast" runs the same kernel as "slices": on the
  TPU it chooses how Mosaic lays out the per-row scale, and on the card a
  per-row scale costs one multiply per score either way. So the bench has
  no "bcast" variant; it times "v3", B2's selection built into B4a,
  beside "v0", B2 itself.
- ``run_dotonly`` (kernel B4b, ``csrc/bench_dotonly.cu``) replaces the TPU
  kernel of the same name, the streaming floor: ``bf16(q) · bf16(row)``
  and a row max, with no scale, mask or selection, on the bf16 tensor
  cores. The reference returns the maximum of the last ``blk``-row block
  only (every grid step overwrites the same (Bq, 1) output block); the
  kernel keeps every block's maximum, (Bq, N / blk), and ``run_dotonly``
  returns the last column unless asked for all. ``dotonly_blocks``
  launches it.

Semantics differing from the reference, on purpose: with ``int8_dot`` the
reference scales the scores before its ``score <= NEG/2`` test, so an empty
slot (fewer valid rows than k) never reads as masked and comes back with a
repeated position; here such slots are −1, marked on the unscaled score as
every other kernel of the repository marks them, with the same values.

A wrapper launches its kernel for CUDA tensors (or raises) and takes its
plain version only for CPU tensors. ``LAUNCHES`` counts kernel launches.

Run on the card (data made there from seed 0; times from CUDA events, the
minimum of ``--reps`` after a warm-up call)::

    python -m nafp_tpu_torch.extras.bench_sq8_kernel            # N 8,388,608
    python -m nafp_tpu_torch.extras.bench_sq8_kernel --nogpu --n 8192

``--nogpu`` runs the plain versions on the CPU (the reference's
``--interpret``): a correctness run at a tiny ``--n`` whose times are not
device times. The reference's ``--vmem_mb`` and its ``v3+vmem`` branch set a
TPU scoped-VMEM limit and have no counterpart here.
"""
from __future__ import annotations

import argparse
import ctypes
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from nafp_tpu_torch import kernels
from nafp_tpu_torch.device import resolve_device
from nafp_tpu_torch.search import topk as T

D = 128
MERGE_MODES = ("v0", "v2", "v3")
SCALE_MODES = ("slices", "bcast")
# the bench's extra variants (the reference's, with "v3" for its "bcast")
VARIANTS = {
    "v3": dict(scale_mode="slices", merge_mode="v3"),
    "v2": dict(scale_mode="slices", merge_mode="v2"),
    "int8": dict(scale_mode="slices", merge_mode="v3", int8_dot=True),
}

LAUNCHES: Dict[str, int] = {"run_variant": 0, "run_dotonly": 0}

_VARIANT_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                     + [ctypes.c_void_p] * 6)
_DOTONLY_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                     + [ctypes.c_void_p] * 2)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def quantize_queries(q: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row int8 queries and their f32 scales, the reference's rule:
    ``qs = max(max|q|, 1e-12) / 127``, ``q8 = clip(round(q / qs))``."""
    qs = q.abs().amax(dim=1).clamp(min=1e-12) / 127.0
    q8 = torch.clamp(torch.round(q / qs[:, None]), -127, 127).to(torch.int8)
    return q8.contiguous(), qs


def _check_blk(n: int, blk: int) -> None:
    if blk <= 0 or blk % 128 or n <= 0 or n % blk:
        raise ValueError(f"blk={blk}, N={n}: N must be a positive multiple "
                         "of blk, and blk of 128 (the reference's (blk/128, "
                         "128) blocks)")


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------
def run_variant_plain(q: torch.Tensor, vecs8: torch.Tensor,
                      scales: torch.Tensor, rmask: torch.Tensor, k: int = 20,
                      int8_dot: bool = False,
                      compute_dtype: torch.dtype = torch.float32
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel B4a (every merge and scale mode
    computes the same function). Without ``int8_dot`` it is B2's plain
    version: q rounded to ``compute_dtype`` (f32 matches the reference's
    interpret mode, bf16 the TPU and the card). With ``int8_dot``: q
    quantised by ``quantize_queries``, exact integer products (f32 holds
    them exactly), times the row scale, plus the row mask, top-k, then
    times the query's scale; −1 where the unscaled score is ≤ NEG/2.
    Returns (scores, positions), each (Bq, k)."""
    if not int8_dot:
        return T.topk_ip_sq8_plain(q, vecs8, scales, rmask, k, compute_dtype)
    T._check_k(k)
    q8, qs = quantize_queries(q)
    qf, rows = q8.float(), vecs8.float()
    v, i = T._plain_topk(
        lambda s, e: (qf[s:e] @ rows.T) * scales[None, :] + rmask[None, :],
        q.shape[0], vecs8.shape[0], k, q.device)
    return v * qs[:, None], i


def run_dotonly_plain(q: torch.Tensor, vecs8: torch.Tensor, blk: int = 2048,
                      compute_dtype: torch.dtype = torch.bfloat16
                      ) -> torch.Tensor:
    """Plain PyTorch version of kernel B4b: every ``blk``-row block's
    maximum of ``q · row``, (Bq, N / blk) f32, with q rounded to
    ``compute_dtype`` (bf16, as the reference computes even in interpret
    mode) and f32 sums."""
    bq, n = q.shape[0], vecs8.shape[0]
    qc = q.to(compute_dtype).float()
    rows = vecs8.float()
    step = max(1, min(bq, T.PLAIN_LOGITS_BUDGET // (4 * n)))
    outs = [(qc[s:s + step] @ rows.T).view(-1, n // blk, blk).amax(dim=2)
            for s in range(0, bq, step)]
    return torch.cat(outs) if outs else q.new_empty((0, n // blk))


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------
def run_variant(q: torch.Tensor, vecs8: torch.Tensor, scales: torch.Tensor,
                rmask: torch.Tensor, k: int = 20, blk: int = 2048,
                scale_mode: str = "slices", merge_mode: str = "v0",
                int8_dot: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over an int8 store, the bench's variants (kernel B4a).

    q (Bq, d) f32; vecs8 (N, d) int8; scales and rmask (N,) f32 (0 /
    NEG). ``blk`` is the reference's row block: it must divide N, and the
    kernel's result does not depend on it. ``scale_mode`` "slices" and
    "bcast" run the same kernel; ``merge_mode`` "v0"/"v3" merges, "v2"
    drains; ``int8_dot`` takes int8 queries (d a multiple of 16). On the
    CPU: the plain version in f32, as the reference's interpret mode.
    Returns (scores f32, positions int32), each (Bq, k)."""
    T._check_k(k)
    if merge_mode not in MERGE_MODES:
        raise ValueError(f"merge_mode={merge_mode!r}: one of {MERGE_MODES}")
    if scale_mode not in SCALE_MODES:
        raise ValueError(f"scale_mode={scale_mode!r}: one of {SCALE_MODES}")
    n, d = vecs8.shape
    _check_blk(n, blk)
    if kernels.all_on_cpu(q, vecs8, scales, rmask):
        return run_variant_plain(q, vecs8, scales, rmask, k, int8_dot)
    bq = q.shape[0]
    T._check_d(d, 16 if int8_dot else 4)
    T._check_cuda("q", q, torch.float32, (bq, d))
    T._check_cuda("vecs8", vecs8, torch.int8, (n, d))
    T._check_cuda("scales", scales, torch.float32, (n,))
    T._check_cuda("rmask", rmask, torch.float32, (n,))
    if bq == 0:
        return (torch.empty((0, k), device=q.device),
                torch.empty((0, k), dtype=torch.int32, device=q.device))
    q_in, qs = quantize_queries(q) if int8_dot else (q, None)
    v, i = T.launch_sq8(kernels.function("bench_variant", _VARIANT_ARGTYPES),
                        "bench_variant", LAUNCHES, "run_variant", q_in, vecs8,
                        scales, rmask, k,
                        flags=(int(int8_dot), int(merge_mode == "v2")))
    return (v * qs[:, None] if int8_dot else v), i


def run_dotonly(q: torch.Tensor, vecs8: torch.Tensor, scales: torch.Tensor,
                rmask: torch.Tensor, blk: int = 2048, all_blocks: bool = False
                ) -> torch.Tensor:
    """The streaming floor (kernel B4b): the maximum of ``bf16(q) · row``
    over the last ``blk``-row block, (Bq, 1) f32, as the reference returns
    it; with ``all_blocks``, every block's, (Bq, N / blk). q (Bq, d) f32,
    vecs8 (N, d) int8; ``scales`` and ``rmask`` are taken for the
    reference's signature and not read, as there. On the CPU: the plain
    version."""
    kernels.all_on_cpu(q, vecs8, scales, rmask)   # raises on mixed devices
    out = dotonly_blocks(q, vecs8, blk)
    return out if all_blocks else out[:, -1:]


def dotonly_blocks(q: torch.Tensor, vecs8: torch.Tensor, blk: int = 2048
                   ) -> torch.Tensor:
    """Every ``blk``-row block's maximum of ``bf16(q) · row``, (Bq, N /
    blk) f32: kernel B4b, which ``run_dotonly`` launches. On the CPU: the
    plain version."""
    n, d = vecs8.shape
    _check_blk(n, blk)
    if kernels.all_on_cpu(q, vecs8):
        return run_dotonly_plain(q, vecs8, blk)
    bq = q.shape[0]
    T._check_d(d)
    T._check_cuda("q", q, torch.float32, (bq, d))
    T._check_cuda("vecs8", vecs8, torch.int8, (n, d))
    out = torch.empty((bq, n // blk), dtype=torch.float32, device=q.device)
    if bq:
        fn = kernels.function("bench_dotonly", _DOTONLY_ARGTYPES)
        with torch.cuda.device(q.device):
            err = fn(q.data_ptr(), vecs8.data_ptr(), bq, n, d, blk,
                     out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"bench_dotonly kernel launch failed: CUDA "
                               f"error {err}")
        LAUNCHES["run_dotonly"] += 1
    return out


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------
def make_data(n: int, bq: int, device: torch.device, seed: int = 0):
    """The bench's inputs, made on ``device`` from ``seed``: int8 rows
    uniform in [-127, 127], row scales uniform in [0.9, 1.1] / 127, a zero
    row mask, and unit queries near randomly picked rows (0.05 noise)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    vecs8 = torch.randint(-127, 128, (n, D), generator=gen, device=device,
                          dtype=torch.int8)
    scales = (torch.rand(n, generator=gen, device=device) * 0.2 + 0.9) / 127
    rmask = torch.zeros(n, device=device)
    pick = torch.randint(0, n, (bq,), generator=gen, device=device)
    q = (vecs8[pick].float() * scales[pick][:, None]
         + 0.05 * torch.randn(bq, D, generator=gen, device=device))
    return q / q.norm(dim=1, keepdim=True), vecs8, scales, rmask


def _timed(fn: Callable, reps: int, device: torch.device):
    """(least ms over ``reps`` calls after one warm-up call, the warm-up
    call's output). On the card each call is timed with CUDA events."""
    out = fn()
    ts = []
    for _ in range(reps):
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e3)
    return min(ts), out


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Dict[str, float]]:
    """Time dotonly, v0 (kernel B2, ``topk_ip_sq8``) and the requested
    variants on one data set; print each variant's ms, QPS and its ids'
    agreement with v0, then ``{name: ms}``. Returns {name: {"ms", "qps",
    and for the variants "ids_agree", "top1"}}."""
    ap = argparse.ArgumentParser(
        prog="python -m nafp_tpu_torch.extras.bench_sq8_kernel",
        description="Time the sq8 scan kernel's variants on the card.")
    ap.add_argument("--n", type=int, default=8_388_608)
    ap.add_argument("--bq", type=int, default=512)
    ap.add_argument("--k", type=int, default=20)
    ap.add_argument("--blk", type=int, default=2048)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--variants", default="v3,v2,int8",
                    help="comma list of extra variants to time, of "
                         f"{','.join(VARIANTS)} (empty = just dotonly + v0)")
    ap.add_argument("--nogpu", action="store_true",
                    help="run the plain versions on the CPU (tiny --n); the "
                         "times are not device times")
    args = ap.parse_args(argv)
    want = [v for v in args.variants.split(",") if v]
    unknown = sorted(set(want) - set(VARIANTS))
    if unknown:
        ap.error(f"unknown variants {unknown}; known: {list(VARIANTS)}")
    n, bq, k, blk = args.n, args.bq, args.k, args.blk
    try:
        _check_blk(n, blk)
        T._check_k(k)
    except ValueError as e:
        ap.error(str(e))
    if args.reps < 1:
        ap.error("--reps must be at least 1")
    dev = resolve_device(nogpu=args.nogpu)
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "CPU, plain versions: not device times")
    print(f"[gen] {n:,} x {D} int8 on {dev} ({where}) ...", flush=True)
    q, vecs8, scales, rmask = make_data(n, bq, dev)

    results: Dict[str, Dict[str, float]] = {}
    t, _ = _timed(lambda: run_dotonly(q, vecs8, scales, rmask, blk=blk),
                  args.reps, dev)
    print(f"dotonly  {t:9.3f} ms   (product + stream floor)", flush=True)
    results["dotonly"] = dict(ms=t, qps=bq / t * 1e3)
    t, (_, ids0) = _timed(lambda: T.topk_ip_sq8(q, vecs8, scales, rmask, k),
                          args.reps, dev)
    print(f"v0       {t:9.3f} ms   {bq / t * 1e3:8.0f} QPS  (kernel B2, "
          "topk_ip_sq8)", flush=True)
    results["v0"] = dict(ms=t, qps=bq / t * 1e3)
    for name in (v for v in VARIANTS if v in want):
        t, (_, ids) = _timed(lambda: run_variant(
            q, vecs8, scales, rmask, k=k, blk=blk, **VARIANTS[name]),
            args.reps, dev)
        agree = float((ids == ids0).float().mean())
        top1 = float((ids[:, 0] == ids0[:, 0]).float().mean())
        print(f"{name:8s} {t:9.3f} ms   {bq / t * 1e3:8.0f} QPS  "
              f"ids-agree {agree:.4f} top1 {top1:.4f}", flush=True)
        results[name] = dict(ms=t, qps=bq / t * 1e3, ids_agree=agree,
                             top1=top1)
    print({name: round(r["ms"], 3) for name, r in results.items()})
    return results


if __name__ == "__main__":
    main()
