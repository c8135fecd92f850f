"""Top-k inner-product search: CUDA kernels B1, B2 and B3, their wrappers
and their plain PyTorch versions.

Counterpart of ``nafp_tpu/search/pallas_topk.py``:

- ``topk_ip`` (kernel B1, ``csrc/topk_f32.cu``) replaces ``topk_ip_pallas``:
  exact f32 top-k of ``q · dbᵀ``;
- ``topk_ip_sq8`` (kernel B2, ``csrc/topk_sq8.cu``) replaces
  ``topk_ip_sq8_pallas``: exact top-k over an int8 store, dequantised on
  the fly as ``(bf16(q) · row) · scale[row] + rmask[row]``;
- ``topk_ip_masked`` (kernel B3, ``csrc/topk_masked.cu``) replaces
  ``topk_ip_pallas_masked``: top-k over a decoded bf16 IVF-PQ chunk with
  per-row ids (−1 masks the row) and an additive bias per (query,
  ``list_tile``-row subtile), the IVF probe mask; positions are mapped
  through the ids.

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
from typing import Dict, Tuple

import torch

NEG = -1e30
MAX_K = 128                 # csrc/topk_common.cuh MAX_K
MAX_D = 256                 # csrc/topk_common.cuh MAX_D
QB = 64                     # queries per scan CTA (csrc/topk_common.cuh)
RB = 64                     # DB rows per scan tile (csrc/topk_common.cuh)
CTAS_PER_SM = 4             # scan CTAs to launch per SM (two waves of two)
PLAIN_LOGITS_BUDGET = 1 << 30   # bytes of one (block, N) plain score matrix

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


def _all_on_cpu(*ts: torch.Tensor) -> bool:
    devs = {t.device.type for t in ts}
    if len(devs) != 1:
        raise ValueError(f"tensors on mixed devices: {sorted(devs)}")
    if devs == {"cpu"}:
        return True
    if devs != {"cuda"} or len({t.device for t in ts}) != 1:
        raise ValueError(f"unsupported devices {[str(t.device) for t in ts]}")
    return False


def _check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype,
                shape) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: must be contiguous and 16-byte aligned")


def _grid(bq: int, n: int, device: torch.device) -> Tuple[int, int]:
    """(chunk_rows, n_chunks): enough scan CTAs for every SM even when
    there are few query blocks."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    qblocks = -(-bq // QB)
    tiles = max(1, -(-n // RB))
    n_chunks = max(1, min(tiles, -(-CTAS_PER_SM * sms // qblocks)))
    chunk_rows = -(-tiles // n_chunks) * RB
    return chunk_rows, -(-max(n, 1) // chunk_rows)


_ARGTYPES = {
    "topk_f32": [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 6
    + [ctypes.c_void_p] * 5,
    "topk_sq8": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
    + [ctypes.c_void_p] * 5,
    "topk_masked": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
    + [ctypes.c_void_p] * 5,
}


def _lib_fn(name: str):
    from nafp_tpu_torch import kernels
    fn = getattr(kernels.load(name), f"nafp_{name}")
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _launch(lib: str, counter: str, q: torch.Tensor, tensors, n: int,
            k: int, extra=()) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``lib``'s scan + merge; ``extra`` are the C function's int
    arguments after k."""
    bq, d = q.shape
    dev = q.device
    chunk_rows, n_chunks = _grid(bq, n, dev)
    part_v = torch.empty((bq, n_chunks, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((bq, n_chunks, k), dtype=torch.int32, device=dev)
    out_v = torch.empty((bq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((bq, k), dtype=torch.int32, device=dev)
    fn = _lib_fn(lib)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), *[t.data_ptr() for t in tensors], bq, n, d,
                 k, *extra, chunk_rows, n_chunks, part_v.data_ptr(),
                 part_i.data_ptr(), out_v.data_ptr(), out_i.data_ptr(),
                 stream)
    if err:
        raise RuntimeError(f"{lib} kernel launch failed: CUDA error {err}")
    LAUNCHES[counter] += 1
    return out_v, out_i


def topk_ip(q: torch.Tensor, db: torch.Tensor, k: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k inner product (kernel B1). q (Bq, d) f32, db (N, d) f32,
    on one CUDA device (or both on the CPU: plain version). Returns
    (scores f32, positions int32), each (Bq, k)."""
    _check_k(k)
    if _all_on_cpu(q, db):
        return topk_ip_plain(q, db, k)
    bq, d = q.shape
    n = db.shape[0]
    if d % 4 or d > MAX_D:
        raise ValueError(f"d={d}: the kernel takes d % 4 == 0, d <= {MAX_D}")
    _check_cuda("q", q, torch.float32, (bq, d))
    _check_cuda("db", db, torch.float32, (n, d))
    if bq == 0:
        return (torch.empty((0, k), device=q.device),
                torch.empty((0, k), dtype=torch.int32, device=q.device))
    return _launch("topk_f32", "topk_ip", q, [db], n, k)


def topk_ip_sq8(q: torch.Tensor, vecs8: torch.Tensor, scales: torch.Tensor,
                rmask: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over an int8 store (kernel B2). q (Bq, d) f32 (rounded
    to bf16 inside the kernel), vecs8 (N, d) int8, scales and rmask (N,)
    f32 (0 / NEG). On the CPU: the plain version in f32, as the JAX
    package's interpret mode. Returns (scores, positions), each (Bq, k)."""
    _check_k(k)
    if _all_on_cpu(q, vecs8, scales, rmask):
        return topk_ip_sq8_plain(q, vecs8, scales, rmask, k, torch.float32)
    bq, d = q.shape
    n = vecs8.shape[0]
    if d % 4 or d > MAX_D:
        raise ValueError(f"d={d}: the kernel takes d % 4 == 0, d <= {MAX_D}")
    _check_cuda("q", q, torch.float32, (bq, d))
    _check_cuda("vecs8", vecs8, torch.int8, (n, d))
    _check_cuda("scales", scales, torch.float32, (n,))
    _check_cuda("rmask", rmask, torch.float32, (n,))
    if bq == 0:
        return (torch.empty((0, k), device=q.device),
                torch.empty((0, k), dtype=torch.int32, device=q.device))
    return _launch("topk_sq8", "topk_ip_sq8", q, [vecs8, scales, rmask], n, k)


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
    if _all_on_cpu(q, db, ids, bias):
        return topk_ip_masked_plain(q, db, ids, bias, k, list_tile)
    if d % 4 or d > MAX_D:
        raise ValueError(f"d={d}: the kernel takes d % 4 == 0, d <= {MAX_D}")
    _check_cuda("q", q, torch.float32, (bq, d))
    _check_cuda("db", db, torch.bfloat16, (n, d))
    _check_cuda("ids", ids, torch.int32, (n,))
    _check_cuda("bias", bias, torch.float32, (bq, n // list_tile))
    if bq == 0:
        return (torch.empty((0, k), device=q.device),
                torch.empty((0, k), dtype=torch.int32, device=q.device))
    v, pos = _launch("topk_masked", "topk_ip_masked", q, [db, ids, bias], n,
                     k, extra=(list_tile,))
    return v, _map_ids(pos, ids)
