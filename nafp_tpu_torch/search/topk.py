"""Top-k inner-product search: CUDA kernels B1, B2 and B3, their wrappers
and their plain PyTorch versions.

Counterpart of ``nafp_tpu/search/pallas_topk.py``:

- ``topk_ip`` (kernel B1, ``csrc/topk_f32.cu``) replaces ``topk_ip_pallas``:
  exact f32 top-k of ``q · dbᵀ``, its products f32-accurate on the TF32
  tensor cores (3xTF32 on ``wgmma``, fed by a producer warp's bulk copies),
  with B3's selection and shared bound and a grid of one wave of CTAs of
  ``qb`` queries each (the kernel's occupancy query says how many);
- ``topk_ip_sq8`` (kernel B2, ``csrc/topk_sq8.cu``) replaces
  ``topk_ip_sq8_pallas``: exact top-k over an int8 store, dequantised on
  the fly as ``(bf16(q) · row) · scale[row] + rmask[row]``. It runs the
  sq8 scan of ``csrc/sq8_scan.cuh`` (B4a's too): products on the bf16
  tensor cores, B3's selection and shared bound, and a grid of one wave
  (``launch_sq8``);
- ``topk_ip_masked`` (kernel B3, ``csrc/topk_masked.cu``) replaces
  ``topk_ip_pallas_masked``: top-k over a decoded bf16 IVF-PQ chunk with
  per-row ids (−1 masks the row) and an additive bias per (query,
  ``list_tile``-row subtile), the IVF probe mask; positions are mapped
  through the ids. Its products run on the bf16 tensor cores, and its
  chunk CTAs share a per-query admission bound (a (Bq,) scratch the
  wrapper allocates).

Semantics kept from the TPU kernels: scores sorted descending; int32
positions into ``db`` (B3: mapped through its ids); −1 wherever the score
is ≤ NEG/2 (masked rows, and the empty slots when k > N); pad and masked
rows never beat real rows, even when every real score is negative; ``k``
at most 128. Ties between equal scores go to the lower position
(``jax.lax.top_k``'s order).

A wrapper launches its kernel for CUDA tensors (or raises) and takes its
plain version only for CPU tensors. ``LAUNCHES`` counts kernel launches,
one per wrapper call that reaches the card.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Sequence, Tuple

import torch

from nafp_tpu_torch.kernels import all_on_cpu

NEG = -1e30
MAX_K = 128                 # csrc/limits.cuh MAX_K
MAX_D = 256                 # csrc/limits.cuh MAX_D
QB = 64                     # queries per scan CTA (B2, B3, B4a; B1 asks)
RB = 64                     # DB rows per scan tile (every scan)
# B3's scan fits two CTAs per SM up to k 80 at d <= 128
# (csrc/topk_masked.cu); one wave
MASKED_CTAS_PER_SM = 2
PLAIN_LOGITS_BUDGET = 1 << 30   # bytes of one (block, N) plain score matrix
# Rows a scan takes: row numbers, chunk starts and ends are int32 in csrc/
# (a chunk's end, row_begin + chunk_rows, stays below 1.5 N + RB < 2^31
# up to here); every byte offset into the rows is a size_t product.
MAX_ROWS = 1 << 30

LAUNCHES: Dict[str, int] = {"topk_ip": 0, "topk_ip_sq8": 0,
                           "topk_ip_masked": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# Selection helper shared by the plain versions and the search code
# ---------------------------------------------------------------------------
def topk_low_index(scores: torch.Tensor, k: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise top-k of a (B, N) tensor, sorted descending, ties broken
    by the lower column (``jax.lax.top_k``'s order; ``torch.topk`` promises
    none). Requires ``k <= N``. Returns (values, int64 columns)."""
    b = scores.shape[0]
    if k == 0 or b == 0:
        return (scores.new_empty((b, k)),
                torch.empty((b, k), dtype=torch.int64, device=scores.device))
    vals = torch.topk(scores, k, dim=1).values
    kth = vals[:, -1:]
    above = scores > kth
    tied = scores == kth
    need = k - above.sum(dim=1, keepdim=True)
    take = above | (tied & (torch.cumsum(tied, dim=1) <= need))
    cols = take.nonzero()[:, 1].view(b, k)            # ascending columns
    picked = scores.gather(1, cols)
    order = torch.sort(picked, dim=1, descending=True, stable=True).indices
    return picked.gather(1, order), cols.gather(1, order)


def _finish(vals: torch.Tensor, cols: torch.Tensor, k: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pad to k slots (NEG / -1) and mark masked results -1."""
    pad = k - vals.shape[1]
    if pad:
        vals = torch.cat([vals, vals.new_full((vals.shape[0], pad), NEG)], 1)
        cols = torch.cat([cols, cols.new_full((cols.shape[0], pad), -1)], 1)
    ids = torch.where(vals <= NEG / 2, torch.full_like(cols, -1), cols)
    return vals, ids.to(torch.int32)


def _plain_topk(score_fn, bq: int, n: int, k: int, device
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Query-blocked (block, N) score matrices -> topk_low_index -> _finish."""
    step = max(1, min(bq, PLAIN_LOGITS_BUDGET // (4 * max(n, 1))))
    outs_v, outs_i = [], []
    for s in range(0, bq, step):
        v, i = topk_low_index(score_fn(s, min(s + step, bq)), min(k, n))
        v, i = _finish(v, i, k)
        outs_v.append(v)
        outs_i.append(i)
    if not outs_v:
        return (torch.empty((0, k), device=device),
                torch.empty((0, k), dtype=torch.int32, device=device))
    return torch.cat(outs_v), torch.cat(outs_i)


def topk_ip_plain(q: torch.Tensor, db: torch.Tensor, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel B1: blocked f32 ``q @ dbᵀ`` and
    top-k. Returns (scores f32, positions int32), each (Bq, k)."""
    _check_k(k)
    q, db = q.float(), db.float()
    return _plain_topk(lambda s, e: q[s:e] @ db.T, q.shape[0], db.shape[0],
                       k, q.device)


def topk_ip_sq8_plain(q: torch.Tensor, vecs8: torch.Tensor,
                      scales: torch.Tensor, rmask: torch.Tensor, k: int,
                      compute_dtype: torch.dtype = torch.float32
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel B2: q rounded to ``compute_dtype``
    (f32 matches the JAX package's interpret mode, bf16 the TPU and the
    CUDA kernel), f32 products with the dequantised rows, times the row
    scale, plus the row mask, then top-k."""
    _check_k(k)
    qc = q.to(compute_dtype).float()
    rows = vecs8.float()
    return _plain_topk(
        lambda s, e: (qc[s:e] @ rows.T) * scales[None, :] + rmask[None, :],
        q.shape[0], vecs8.shape[0], k, q.device)


def _map_ids(pos: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Positions into the chunk -> its row ids; -1 stays -1."""
    return torch.where(pos < 0, -1, ids[pos.clamp(min=0).long()]).to(
        torch.int32)


def topk_ip_masked_plain(q: torch.Tensor, db: torch.Tensor,
                         ids: torch.Tensor, bias: torch.Tensor, k: int,
                         list_tile: int,
                         compute_dtype: torch.dtype = torch.float32
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel B3 (the JAX package's
    ``_pq_score_chunk_xla``): q rounded to ``compute_dtype`` (f32 matches
    the JAX package on the CPU, bf16 the TPU and the CUDA kernel), f32
    products with the rows, plus the subtile's bias, NEG where the row's id
    is < 0, then top-k. Returns (scores, row ids), each (Bq, k); −1 where
    the score is ≤ NEG/2."""
    _check_k(k)
    qc = q.to(compute_dtype).float()
    rows = db.float()
    invalid = (ids < 0)[None, :]

    def score(s, e):
        sim = qc[s:e] @ rows.T + bias[s:e].repeat_interleave(list_tile, 1)
        return sim.masked_fill(invalid, NEG)
    v, pos = _plain_topk(score, q.shape[0], db.shape[0], k, q.device)
    return v, _map_ids(pos, ids)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------
def _check_k(k: int) -> None:
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} outside [1, {MAX_K}]: the running top-k "
                         "lives in shared memory")


def _check_d(d: int, multiple: int = 4) -> None:
    """The kernels' rule for the row width on the card."""
    if d <= 0 or d % multiple or d > MAX_D:
        raise ValueError(f"d={d}: the kernel takes d % {multiple} == 0, "
                         f"0 < d <= {MAX_D}")


def _check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype,
                shape) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: must be contiguous and 16-byte aligned")


def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _grid(bq: int, n: int, device: torch.device, ctas_per_sm: int,
          qb: int = QB) -> Tuple[int, int]:
    """(chunk_rows, n_chunks) of a scan on ``device`` at ``ctas_per_sm``
    scan CTAs per SM of ``qb`` queries each: B3's ``MASKED_CTAS_PER_SM``;
    B1's and the sq8 scan's, the CTAs one SM holds (``_resident``,
    ``_b1_shape``)."""
    return _plan_chunks(bq, n, _sm_count(device), ctas_per_sm, qb)


def _plan_chunks(bq: int, n: int, sms: int, ctas_per_sm: int,
                 qb: int = QB) -> Tuple[int, int]:
    """(chunk_rows, n_chunks): at most ``ctas_per_sm * sms`` scan CTAs of
    ``qb`` queries each (the chunk count is rounded down: a second wave of
    a few CTAs would nearly double the time), so every SM has work even
    when there are few query blocks; at least one chunk, of whole RB-row
    tiles."""
    qblocks = -(-bq // qb)
    tiles = max(1, -(-n // RB))
    n_chunks = max(1, min(tiles, ctas_per_sm * sms // qblocks))
    chunk_rows = -(-tiles // n_chunks) * RB
    return chunk_rows, -(-max(n, 1) // chunk_rows)


@functools.lru_cache(maxsize=None)
def _resident(device_index: int, lib: str, *args: int) -> int:
    """CTAs of library ``lib``'s scan that one SM holds for the
    occupancy query's ``args``, on CUDA device ``device_index``."""
    from nafp_tpu_torch import kernels
    with torch.cuda.device(device_index):
        return kernels.occupancy(lib, *args)[1]


@functools.lru_cache(maxsize=None)
def _b1_shape(device_index: int, d: int, k: int) -> Tuple[int, int]:
    """(CTAs one SM holds, queries per CTA) of B1's scan at (d, k) on CUDA
    device ``device_index`` (its occupancy query)."""
    from nafp_tpu_torch import kernels
    with torch.cuda.device(device_index):
        info = kernels.occupancy("topk_f32", d, k, n_out=4)
    return info[1], info[3]


_ARGTYPES = {
    "topk_f32": [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 6
    + [ctypes.c_void_p] * 6,
    "topk_sq8": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
    + [ctypes.c_void_p] * 6,
    "topk_masked": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
    + [ctypes.c_void_p] * 6,
}


def _lib_fn(name: str):
    from nafp_tpu_torch import kernels
    return kernels.function(name, _ARGTYPES[name])


def _launch(fn, counts: Dict[str, int], counter: str, q: torch.Tensor,
            tensors, n: int, k: int, ctas_per_sm: int, extra=(), scratch=(),
            qb: int = QB) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch a scan + merge C entry point ``fn``; ``extra`` are its int
    arguments after k, ``scratch`` its tensors after n_chunks, and the
    grid asks for ``ctas_per_sm`` scan CTAs per SM of ``qb`` queries each.
    Adds one to ``counts[counter]`` once it launched."""
    bq, d = q.shape
    dev = q.device
    if n > MAX_ROWS:
        raise ValueError(f"{n} rows: a scan takes at most {MAX_ROWS}")
    chunk_rows, n_chunks = _grid(bq, n, dev, ctas_per_sm, qb)
    part_v = torch.empty((bq, n_chunks, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((bq, n_chunks, k), dtype=torch.int32, device=dev)
    out_v = torch.empty((bq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((bq, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), *[t.data_ptr() for t in tensors], bq, n, d,
                 k, *extra, chunk_rows, n_chunks,
                 *[t.data_ptr() for t in scratch], part_v.data_ptr(),
                 part_i.data_ptr(), out_v.data_ptr(), out_i.data_ptr(),
                 stream)
    if err:
        raise RuntimeError(f"{fn.__name__} kernel launch failed: CUDA error "
                           f"{err}")
    counts[counter] += 1
    return out_v, out_i


def launch_sq8(fn, lib: str, counts: Dict[str, int], counter: str,
               q: torch.Tensor, vecs8: torch.Tensor, scales: torch.Tensor,
               rmask: torch.Tensor, k: int, flags: Sequence[int] = (),
               ctas_per_sm: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the sq8 scan + merge, C entry point ``fn`` of library
    ``lib`` (B2: "topk_sq8"; B4a: "bench_variant" with ``flags``
    (int8_dot, drain)), on CUDA tensors the caller has checked: q (Bq, d)
    f32 (B4a's int8_dot: int8). The grid asks for ``ctas_per_sm`` scan
    CTAs per SM, by default as many as one SM holds for this instance (its
    occupancy query): one wave. The chunk CTAs share a per-query admission
    bound, a (Bq,) scratch filled with NEG."""
    bq, d = q.shape
    ctas = ctas_per_sm or _resident(q.device.index or 0, lib, d, k, *flags)
    bound = torch.full((bq,), NEG, dtype=torch.float32, device=q.device)
    return _launch(fn, counts, counter, q, [vecs8, scales, rmask],
                   vecs8.shape[0], k, ctas, extra=tuple(flags),
                   scratch=[bound])


def topk_ip(q: torch.Tensor, db: torch.Tensor, k: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k inner product (kernel B1). q (Bq, d) f32, db (N, d) f32,
    on one CUDA device (or both on the CPU: plain version). The grid is one
    wave of the CTAs an SM holds, each of as many queries as the scan takes
    at this d (both from the occupancy query), and the chunk CTAs share a
    per-query admission bound, a (Bq,) scratch filled with NEG. Returns
    (scores f32, positions int32), each (Bq, k)."""
    _check_k(k)
    if all_on_cpu(q, db):
        return topk_ip_plain(q, db, k)
    bq, d = q.shape
    n = db.shape[0]
    _check_d(d)
    _check_cuda("q", q, torch.float32, (bq, d))
    _check_cuda("db", db, torch.float32, (n, d))
    if bq == 0:
        return (torch.empty((0, k), device=q.device),
                torch.empty((0, k), dtype=torch.int32, device=q.device))
    ctas, qb = _b1_shape(q.device.index or 0, d, k)
    bound = torch.full((bq,), NEG, dtype=torch.float32, device=q.device)
    return _launch(_lib_fn("topk_f32"), LAUNCHES, "topk_ip", q, [db], n, k,
                   ctas, scratch=[bound], qb=qb)


def topk_ip_sq8(q: torch.Tensor, vecs8: torch.Tensor, scales: torch.Tensor,
                rmask: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over an int8 store (kernel B2). q (Bq, d) f32 (rounded
    to bf16 inside the kernel), vecs8 (N, d) int8, scales and rmask (N,)
    f32 (0 / NEG). On the CPU: the plain version in f32, as the JAX
    package's interpret mode. Returns (scores, positions), each (Bq, k)."""
    _check_k(k)
    if all_on_cpu(q, vecs8, scales, rmask):
        return topk_ip_sq8_plain(q, vecs8, scales, rmask, k, torch.float32)
    bq, d = q.shape
    n = vecs8.shape[0]
    _check_d(d)
    _check_cuda("q", q, torch.float32, (bq, d))
    _check_cuda("vecs8", vecs8, torch.int8, (n, d))
    _check_cuda("scales", scales, torch.float32, (n,))
    _check_cuda("rmask", rmask, torch.float32, (n,))
    if bq == 0:
        return (torch.empty((0, k), device=q.device),
                torch.empty((0, k), dtype=torch.int32, device=q.device))
    return launch_sq8(_lib_fn("topk_sq8"), "topk_sq8", LAUNCHES,
                      "topk_ip_sq8", q, vecs8, scales, rmask, k)


def topk_ip_masked(q: torch.Tensor, db: torch.Tensor, ids: torch.Tensor,
                   bias: torch.Tensor, k: int, list_tile: int = 128
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k with per-row ids and a per-(query, subtile) bias (kernel B3).

    q (Bq, d) f32 (rounded to bf16 inside the kernel); db (N, d) bf16, the
    decoded chunk; ids (N,) int32, −1 marks an invalid row anywhere; bias
    (Bq, N // list_tile) f32, added to every score of the subtile (0 / NEG:
    the IVF probe mask). ``list_tile`` is a multiple of 64 (the kernel's
    row tile). On the CPU: the plain version in f32, as the JAX package
    scores there. Returns (scores f32, row ids int32), each (Bq, k)."""
    _check_k(k)
    if list_tile <= 0 or list_tile % RB:
        raise ValueError(f"list_tile={list_tile}: must be a multiple of {RB}")
    bq, d = q.shape
    n = db.shape[0]
    if n % list_tile or tuple(bias.shape) != (bq, n // list_tile):
        raise ValueError(f"bias {tuple(bias.shape)} does not match "
                         f"(Bq, N / list_tile) = ({bq}, {n} / {list_tile})")
    if all_on_cpu(q, db, ids, bias):
        return topk_ip_masked_plain(q, db, ids, bias, k, list_tile)
    _check_d(d)
    _check_cuda("q", q, torch.float32, (bq, d))
    _check_cuda("db", db, torch.bfloat16, (n, d))
    _check_cuda("ids", ids, torch.int32, (n,))
    _check_cuda("bias", bias, torch.float32, (bq, n // list_tile))
    if bq == 0:
        return (torch.empty((0, k), device=q.device),
                torch.empty((0, k), dtype=torch.int32, device=q.device))
    # the admission bound the chunk CTAs share, raised by the scan
    bound = torch.full((bq,), NEG, dtype=torch.float32, device=q.device)
    out_v, out_i = _launch(_lib_fn("topk_masked"), LAUNCHES, "topk_ip_masked",
                           q, [db, ids, bias], n, k, MASKED_CTAS_PER_SM,
                           extra=(list_tile,), scratch=[bound])
    return out_v, _map_ids(out_i, ids)
