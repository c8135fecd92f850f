"""Vector indexes on the GPU: f32 flat, int8 flat, k-means and IVF-PQ.

Counterpart of ``nafp_tpu/search/index.py`` (``FlatIndex``,
``SQ8FlatIndex``, ``kmeans``, ``IVFPQIndex``, ``get_index``,
``cacheable_cls``), itself the replacement of the reference's FAISS
backend (``eval/utils/get_index_faiss.py``). Fingerprints are
L2-normalised, so L2 ranking equals inner-product ranking. IVF-SQ8, hnsw
and the sharded indexes are later work and raise ``NotImplementedError``
here.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from nafp_tpu_torch.device import DeviceLike, resolve_device
from nafp_tpu_torch.search.topk import (NEG, topk_ip, topk_ip_masked,
                                        topk_ip_sq8, topk_low_index)

# Index types of the JAX package still to port (ROADMAP.md).
_LATER = {
    "ivf-sq8": "IVF-SQ8 (Queue 1, item 10)",
    "hnsw": "hnsw (Queue 1, item 10)",
    "l2-sharded": "sharded search (Queue 1, item 11)",
    "sq8-sharded": "sharded search (Queue 1, item 11)",
    "ivf-sq8-sharded": "sharded search (Queue 1, item 11)",
}


def _not_ported(index_type: str) -> NotImplementedError:
    return NotImplementedError(
        f"index type {index_type!r} is not ported to nafp_tpu_torch yet: "
        f"{_LATER[index_type]} in ROADMAP.md, a later slice. Ported: l2, "
        "ip, ivf, sq8, sq8-flat, ivfpq, ivfpq-rr")


# ---------------------------------------------------------------------------
# Exact flat index
# ---------------------------------------------------------------------------
class FlatIndex:
    """Exact search over a device-resident (N, d) f32 matrix.

    At ``PALLAS_MIN_ROWS`` rows and above, with an inner-product-rankable
    metric ('ip' always, 'l2' when every row has the same norm), search
    goes through kernel B1 (``topk_ip``) in query blocks of at most 512,
    and 'l2' distances are recovered on the host as
    ``q² + db²[id] − 2·ip``. Below it, or for an l2 DB of unequal norms, a
    query block is one ``q @ dbᵀ`` and a top-k over the (block, N) scores,
    blocked so that matrix stays within ``XLA_LOGITS_BUDGET`` (the JAX
    package computes this route outside any Pallas kernel too).
    """

    # The names are the JAX package's, kept so either reads like the other.
    PALLAS_MIN_ROWS = 50_000
    XLA_LOGITS_BUDGET = 1 << 30

    def __init__(self, db: np.ndarray, metric: str = "l2",
                 device: DeviceLike = None):
        if metric not in ("l2", "ip"):
            raise ValueError(f"metric must be 'l2' or 'ip', got {metric!r}")
        self.metric = metric
        self.device = resolve_device(device)
        db_host = np.ascontiguousarray(db, np.float32)
        self.db = torch.from_numpy(db_host).to(self.device)
        # host copy of the row norms for the kernel route's L2^2 recovery
        self._db_sq_host = np.einsum("nd,nd->n", db_host, db_host)
        self.db_sq = torch.from_numpy(self._db_sq_host).to(self.device)
        self.ntotal = self.db.shape[0]
        # Relative 1e-5 spread test: f32-normalised rows sit at ~1e-7
        # relative spread; an absolute cutoff would re-rank near-but-not-
        # equal-norm DBs by IP while the class promises exact L2.
        if self.ntotal:
            mx = float(self._db_sq_host.max())
            spread = mx - float(self._db_sq_host.min())
            self._unit_norm = spread <= 1e-5 * max(abs(mx), 1e-12)
        else:
            self._unit_norm = True

    def _search_block(self, q: torch.Tensor, k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        sim = q @ self.db.T
        if self.metric == "l2":
            # ||q-x||^2 = ||q||^2 + ||x||^2 - 2 q.x ; ||q||^2 is rank-const
            score = 2.0 * sim - self.db_sq[None, :]
            d, ids = topk_low_index(score, k)
            q_sq = torch.sum(q * q, dim=1, keepdim=True)
            return q_sq - d, ids          # actual L2^2 distances
        return topk_low_index(sim, k)

    def _xla_block_cap(self, block: int) -> int:
        """Largest query block whose (block, N) f32 score matrix fits
        XLA_LOGITS_BUDGET (>= 1)."""
        if self.ntotal == 0:
            return block
        return max(1, min(block, self.XLA_LOGITS_BUDGET // (4 * self.ntotal)))

    def _use_kernel(self) -> bool:
        if self.ntotal < self.PALLAS_MIN_ROWS:
            return False
        return self.metric == "ip" or self._unit_norm

    def search(self, q: np.ndarray, k: int,
               block: int = 2048) -> Tuple[np.ndarray, np.ndarray]:
        q = np.asarray(q, np.float32)
        use_kernel = self._use_kernel()
        block = min(block, 512) if use_kernel else self._xla_block_cap(block)
        outs_d, outs_i = [], []
        for s in range(0, len(q), block):
            blk = q[s:s + block]
            pad = 0
            # only a multi-block search pads its last block (the kernel
            # therefore sees any block size from 1 to 512)
            if len(blk) < min(block, len(q)) and len(q) > block:
                pad = block - len(blk)
                blk = np.pad(blk, ((0, pad), (0, 0)))
            qt = torch.from_numpy(np.ascontiguousarray(blk)).to(self.device)
            if use_kernel:
                d, ids = topk_ip(qt, self.db, k)
                d, ids = d.cpu().numpy(), ids.cpu().numpy()
                if self.metric == "l2":
                    # IP -> L2^2 on the k-sized result (host gather)
                    q_sq = np.einsum("nd,nd->n", blk, blk)
                    d = (q_sq[:, None]
                         + self._db_sq_host[np.maximum(ids, 0)] - 2.0 * d)
            else:
                d, ids = self._search_block(qt, k)
                d, ids = d.cpu().numpy(), ids.cpu().numpy().astype(np.int32)
            n = len(blk) - pad
            outs_d.append(d[:n])
            outs_i.append(ids[:n])
        if not outs_d:
            return (np.zeros((0, k), np.float32), np.zeros((0, k), np.int32))
        return np.concatenate(outs_d), np.concatenate(outs_i)


# ---------------------------------------------------------------------------
# Exact int8 flat index (kernel B2)
# ---------------------------------------------------------------------------
def _pad_sq8_store(q8, scales, ids, multiple: int):
    """Repad a quantized store to a row multiple: zero vectors, scale 0,
    id -1 (the kernel masks on id < 0)."""
    extra = (-len(q8)) % multiple
    if extra:
        d = q8.shape[1]
        q8 = np.concatenate([q8, np.zeros((extra, d), np.int8)])
        scales = np.concatenate([scales, np.zeros(extra, np.float32)])
        ids = np.concatenate([ids, np.full(extra, -1, np.int32)])
    return q8, scales, ids


def _quantize_sq8_host(data, pad_multiple: int, block: int = 1 << 20):
    """Host-side per-row int8 quantization of an array or disk memmap,
    padded to a multiple of ``pad_multiple`` rows (pad rows id -1 / scale
    0). Returns (q8, scales, ids) host arrays, byte-identical to the JAX
    package's."""
    n, d = len(data), data.shape[1]
    pad = (-n) % pad_multiple
    q8 = np.zeros((n + pad, d), np.int8)
    scales = np.zeros(n + pad, np.float32)
    xbuf = np.empty((min(block, n), d), np.float32)   # warm reused buffer
    for s in range(0, n, block):
        e = min(s + block, n)
        x = xbuf[:e - s]
        x[:] = data[s:e]
        sc = np.maximum(np.abs(x).max(axis=1), 1e-12) / 127.0
        x /= sc[:, None]
        np.rint(x, out=x)
        np.clip(x, -127, 127, out=x)
        q8[s:e] = x
        scales[s:e] = sc
    ids = np.full(n + pad, -1, np.int32)
    ids[:n] = np.arange(n, dtype=np.int32)
    return q8, scales, ids


class SQ8FlatIndex:
    """Exact search over an int8-quantized device-resident store.

    int8 + a per-row scale is 132 B/row (4x smaller than f32); kernel B2
    (``topk_ip_sq8``) scans it with the row mask hiding pad rows and
    tombstones. The ``.npz`` store (``ntotal, vecs8, scales, ids``) is the
    JAX package's format: a store written by either package loads in the
    other.
    """

    BLK = 2048          # the store is padded to a multiple of this

    def __init__(self, d: int = 128, device: DeviceLike = None):
        self.d = d
        self.ntotal = 0
        self.device = resolve_device(device)

    def add(self, data, block: int = 1 << 20,
            persist_path: Optional[str] = None) -> None:
        """Quantize on the host, optionally persist, upload."""
        n = len(data)
        q8, scales, ids = _quantize_sq8_host(data, self.BLK, block)
        self.ntotal = n
        if persist_path:
            np.savez(persist_path, ntotal=n, vecs8=q8, scales=scales,
                     ids=ids)
        self._publish(q8, scales, ids)

    def _publish(self, q8: np.ndarray, scales: np.ndarray,
                 ids: np.ndarray) -> None:
        dev = self.device
        self.vecs8 = torch.from_numpy(np.ascontiguousarray(q8)).to(dev)
        self.scales = torch.from_numpy(
            np.ascontiguousarray(scales, np.float32)).to(dev)
        self.ids = torch.from_numpy(
            np.ascontiguousarray(ids, np.int32)).to(dev)
        self.rmask = torch.where(self.ids >= 0, 0.0, NEG).to(torch.float32)

    @classmethod
    def load(cls, path: str, device: DeviceLike = None) -> "SQ8FlatIndex":
        """Load a store persisted by ``add(persist_path=...)`` (by either
        package)."""
        with np.load(path) as z:
            q8, scales, ids = z["vecs8"], z["scales"], z["ids"]
            ntotal = int(z["ntotal"])
        idx = cls(d=q8.shape[1], device=device)
        idx.ntotal = ntotal
        idx._publish(*_pad_sq8_store(q8, scales, ids, cls.BLK))
        return idx

    def search(self, q: np.ndarray, k: int,
               block: int = 1024) -> Tuple[np.ndarray, np.ndarray]:
        q = np.asarray(q, np.float32)
        block = min(block, (16 << 20) // (self.BLK * 4))
        outs_d, outs_i = [], []
        for s in range(0, len(q), block):
            blk = q[s:s + block]
            pad = block - len(blk) if len(blk) < block and len(q) > block \
                else 0
            if pad:
                blk = np.pad(blk, ((0, pad), (0, 0)))
            qt = torch.from_numpy(np.ascontiguousarray(blk)).to(self.device)
            v, pos = topk_ip_sq8(qt, self.vecs8, self.scales, self.rmask, k)
            ids = torch.where(pos < 0, -1, self.ids[pos.clamp(min=0).long()])
            n = len(blk) - pad
            outs_d.append(v[:n].cpu().numpy())
            outs_i.append(ids[:n].cpu().numpy())
        if not outs_d:
            return (np.zeros((0, k), np.float32), np.zeros((0, k), np.int32))
        return np.concatenate(outs_d), np.concatenate(outs_i)


# ---------------------------------------------------------------------------
# K-means (Lloyd iterations as matmuls)
# ---------------------------------------------------------------------------
def _kmeanspp_init(data: torch.Tensor, k: int,
                   gen: torch.Generator) -> torch.Tensor:
    """k-means++ seeding: each next centroid is a data row drawn ∝ its
    squared distance to the nearest chosen one (+1e-12, as the JAX
    package). Draws come from ``gen`` on data's device: they are not
    ``jax.random``'s, so the seeding matches the JAX package in law, not
    draw for draw."""
    n, d = data.shape
    first = torch.randint(n, (1,), generator=gen, device=data.device)
    cents = torch.empty((k, d), dtype=data.dtype, device=data.device)
    cents[:1] = data.index_select(0, first)
    d2 = ((data - cents[:1]) ** 2).sum(1)
    for i in range(1, k):
        nxt = data.index_select(0, torch.multinomial(d2 + 1e-12, 1,
                                                     generator=gen))
        cents[i:i + 1] = nxt
        d2 = torch.minimum(d2, ((data - nxt) ** 2).sum(1))
    return cents


def _lloyd_accum(data: torch.Tensor, cents: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Partial Lloyd statistics of one data block: the one-hot segment sums
    as one matmul (deterministic on the card, where atomics are not) ->
    (sums (k, d), counts (k,))."""
    k = cents.shape[0]
    c_sq = (cents ** 2).sum(1)
    sim = 2.0 * (data @ cents.T) - c_sq[None, :]
    assign = sim.argmax(1)            # first maximum, as jnp.argmax
    onehot = torch.zeros((data.shape[0], k), dtype=data.dtype,
                         device=data.device).scatter_(1, assign[:, None], 1.0)
    return onehot.T @ data, onehot.sum(0)


def _lloyd_step(data: torch.Tensor, cents: torch.Tensor,
                block: Optional[int] = None) -> torch.Tensor:
    """One Lloyd iteration, blocked over the data so the (n, k) one-hot
    stays around 1 GB f32. Empty clusters keep their centroid."""
    k, d = cents.shape
    n = data.shape[0]
    if block is None:
        block = max(8192, (1 << 28) // k)
    if n * k <= (1 << 28):
        sums, counts = _lloyd_accum(data, cents)
    else:
        sums = torch.zeros((k, d), dtype=torch.float32, device=data.device)
        counts = torch.zeros((k,), dtype=torch.float32, device=data.device)
        for s in range(0, n, block):
            ps, pc = _lloyd_accum(data[s:s + block], cents)
            sums, counts = sums + ps, counts + pc
    counts = counts[:, None]
    new = sums / counts.clamp(min=1.0)
    return torch.where(counts > 0, new, cents)


def _assign_block(data: torch.Tensor, cents: torch.Tensor) -> torch.Tensor:
    c_sq = (cents ** 2).sum(1)
    sim = 2.0 * (data @ cents.T) - c_sq[None, :]
    return sim.argmax(1).to(torch.int32)


def assign_to_centroids(data: np.ndarray, centroids: torch.Tensor,
                        block: int = 262144) -> np.ndarray:
    """Blockwise nearest-centroid assignment on the centroids' device."""
    out = np.empty(len(data), np.int32)
    for s in range(0, len(data), block):
        blk = torch.from_numpy(np.ascontiguousarray(data[s:s + block],
                                                    np.float32))
        out[s:s + len(blk)] = _assign_block(blk.to(centroids.device),
                                            centroids).cpu().numpy()
    return out


def kmeans(data: torch.Tensor, k: int, iters: int = 10,
           seed: int = 0) -> torch.Tensor:
    """Lloyd k-means with k-means++ seeding on data's device; the draws
    come from a ``torch.Generator`` seeded with ``seed``."""
    gen = torch.Generator(device=data.device).manual_seed(seed)
    cents = _kmeanspp_init(data, k, gen)
    for _ in range(iters):
        cents = _lloyd_step(data, cents)
    return cents


# ---------------------------------------------------------------------------
# IVF-PQ (kernel B3)
# ---------------------------------------------------------------------------
class IVFPQIndex:
    """IVF-PQ searched by decode-and-scan, the JAX package's design.

    The PQ score ``q · (centroid + Σ_m codeword_m[code_m])`` is the inner
    product of q with the decoded row, and a decode is shared by every
    query of a search call. So search decodes each DB chunk once (a gather
    of codewords plus the list's centroid, cast to bf16) and scans it with
    kernel B3 (``topk_ip_masked``) per query block; the IVF probe set is an
    additive 0 / NEG bias per (query, ``LIST_TILE``-row subtile), since
    every subtile holds rows of exactly one inverted list. Storage stays at
    PQ size: codes (N, m) uint8, 64 B/row with the reference's parameters
    (nlist 256, m 64 × 8 bits, nprobe 40; ``get_index_faiss.py:69-74,120``).

    ``refine`` (``ivfpq-rr``): keep the raw vectors on the device and
    rescore the top 4·k candidates exactly in f32.
    """

    LIST_TILE = 128   # rows per single-list subtile (probe-mask granularity)
    BLK = 1024        # the store is padded to a multiple of this
    # rows per device encode / assignment step: the (rows, m, ksub) f32
    # similarity of 16,384 rows at m 64 is 1 GB
    ENCODE_ROWS = 16384
    ASSIGN_ROWS = 262144
    # default DB-chunk rows per decode pass (tests shrink it to exercise
    # multi-chunk merging)
    CHUNK_ROWS = 1 << 21
    # Probe-pruned decode: the chunk-major loop decodes the whole store per
    # search call; when the union of the probed lists covers no more than
    # this share of the subtiles, search gathers only those subtiles into a
    # compact copy and scans that. At nlist 256 / nprobe 40 the union is
    # ~16 % of the store for one query and ~100 % from ~32 queries on, so
    # the protocol's batched searches stay on the linear scan.
    PRUNE_COVERAGE = 0.5

    def __init__(self, d: int = 128, nlist: int = 256, m: int = 64,
                 nbits: int = 8, nprobe: int = 40, refine: bool = False,
                 device: DeviceLike = None):
        if d % m:
            raise ValueError(f"d={d} is not a multiple of m={m}")
        self.d, self.nlist, self.m, self.nprobe = d, nlist, m, nprobe
        self.ksub = 2 ** nbits
        self.dsub = d // m
        self.refine = refine
        self.device = resolve_device(device)
        self.ntotal = 0
        self._trained = False

    # -- train -------------------------------------------------------------
    def train(self, data: np.ndarray, max_train: int = int(1e7),
              kmeans_iters: int = 10, seed: int = 0) -> None:
        if len(data) < self.nlist * 4:
            raise ValueError(
                f"IVF-PQ needs >= {self.nlist * 4} training vectors for "
                f"nlist={self.nlist} (got {len(data)}); use the exact 'l2'/"
                "'ip' index for small databases")
        # subsample BEFORE full conversion (data may be a disk memmap)
        if len(data) > max_train:
            sel = np.sort(np.random.default_rng(seed)
                          .permutation(len(data))[:max_train])
            data = np.asarray(data[sel], np.float32)
        else:
            data = np.asarray(data, np.float32)
        x = torch.from_numpy(np.ascontiguousarray(data)).to(self.device)
        self.centroids = kmeans(x, self.nlist, iters=kmeans_iters,
                                seed=seed)                     # (nlist, d)
        # PQ codebooks on the residuals (lists assigned on the resident rows)
        assign = torch.cat([
            _assign_block(x[s:s + self.ASSIGN_ROWS], self.centroids)
            for s in range(0, len(x), self.ASSIGN_ROWS)])
        resid = (x - self.centroids[assign.long()]).view(-1, self.m,
                                                          self.dsub)
        del x
        self.codebooks = torch.stack([
            kmeans(resid[:, mi].contiguous(), self.ksub, iters=kmeans_iters,
                   seed=seed + 1 + mi)
            for mi in range(self.m)])                    # (m, ksub, dsub)
        self._trained = True

    # -- add ---------------------------------------------------------------
    def add(self, data, block: int = 1 << 20,
            persist_path: Optional[str] = None) -> None:
        """Encode and store (one add per index).

        Layout: rows sorted by coarse list, each list padded to a multiple
        of LIST_TILE rows (at least one subtile; pad rows carry id −1), the
        total padded to a multiple of BLK with filler subtiles (list −1).
        ``data`` (an array or a disk memmap) is streamed block by block;
        the only O(N) host buffers are the uint8 codes and int32
        assignment/order arrays. ``persist_path``: save the store as
        ``.npz`` (the JAX package's keys) before the upload.
        """
        if not self._trained:
            raise RuntimeError("train() before add()")
        lt = self.LIST_TILE
        n = len(data)
        cents_np = self.centroids.cpu().numpy()
        # pass 1: coarse assignment, streamed off the source into a reused
        # buffer
        assign = np.empty(n, np.int32)
        xbuf = np.empty((min(block, n), self.d), np.float32)
        for s in range(0, n, block):
            e = min(s + block, n)
            blk_rows = xbuf[:e - s]
            blk_rows[:] = data[s:e]
            assign[s:e] = assign_to_centroids(blk_rows, self.centroids,
                                              block=self.ASSIGN_ROWS)
        order = np.argsort(assign, kind="stable")
        sorted_assign = assign[order]

        # pass 2: gather sorted rows in blocks, PQ-encode the residuals
        books_np = self.codebooks.cpu().numpy()
        codes = np.empty((n, self.m), np.uint8)
        eb = 65536
        rowbuf = np.empty((min(eb, n), self.d), np.float32)
        centbuf = np.empty((min(eb, n), self.d), np.float32)
        for s in range(0, n, eb):
            e = min(s + eb, n)
            rows = rowbuf[:e - s]
            np.take(data, order[s:e], axis=0, out=rows)
            cb = centbuf[:e - s]
            np.take(cents_np, sorted_assign[s:e], axis=0, out=cb)
            rows -= cb                                  # residuals in place
            codes[s:e] = self._encode_block(
                torch.from_numpy(rows).to(self.device)).cpu().numpy()

        counts = np.bincount(sorted_assign, minlength=self.nlist)
        padded = np.maximum((counts + lt - 1) // lt, 1) * lt
        n_pad = int(padded.sum())
        n_pad += (-n_pad) % self.BLK            # filler subtiles at the end
        starts_p = np.concatenate([[0], np.cumsum(padded)[:-1]])
        starts_u = np.concatenate([[0], np.cumsum(counts)[:-1]])

        codes_pad = np.zeros((n_pad, self.m), np.uint8)
        ids_pad = np.full(n_pad, -1, np.int32)
        sub_list = np.full(n_pad // lt, -1, np.int32)
        for li in range(self.nlist):
            c, sp = counts[li], starts_p[li]
            codes_pad[sp:sp + c] = codes[starts_u[li]:starts_u[li] + c]
            ids_pad[sp:sp + c] = order[starts_u[li]:starts_u[li] + c]
            sub_list[sp // lt:(sp + padded[li]) // lt] = li

        if persist_path:
            np.savez(persist_path, nlist=self.nlist, m=self.m,
                     ksub=self.ksub, ntotal=n, centroids=cents_np,
                     codebooks=books_np, codes=codes_pad, ids=ids_pad,
                     sub_list=sub_list)
        self._publish(codes_pad, ids_pad, sub_list)
        self.raw = (torch.from_numpy(np.ascontiguousarray(data, np.float32))
                    .to(self.device) if self.refine else None)
        self.ntotal = n

    def _publish(self, codes: np.ndarray, ids: np.ndarray,
                 sub_list: np.ndarray) -> None:
        dev = self.device
        self.codes = torch.from_numpy(np.ascontiguousarray(codes)).to(dev)
        self.ids = torch.from_numpy(
            np.ascontiguousarray(ids, np.int32)).to(dev)   # row -> orig id
        self.sub_list = torch.from_numpy(
            np.ascontiguousarray(sub_list, np.int32)).to(dev)
        self.n_pad = int(self.codes.shape[0])

    @classmethod
    def load(cls, path: str, nprobe: int = 40,
             device: DeviceLike = None) -> "IVFPQIndex":
        """Load a store persisted by ``add(persist_path=...)`` (by either
        package). ``refine`` stores are not persisted: the raw vectors
        dominate their size."""
        with np.load(path) as z:
            cents, books = z["centroids"], z["codebooks"]
            codes, ids, sub_list = z["codes"], z["ids"], z["sub_list"]
            nlist, m = int(z["nlist"]), int(z["m"])
            nbits = int(z["ksub"]).bit_length() - 1
            ntotal = int(z["ntotal"])
        idx = cls(d=int(cents.shape[1]), nlist=nlist, m=m, nbits=nbits,
                  nprobe=nprobe, device=device)
        idx.centroids = torch.from_numpy(cents).to(idx.device)
        idx.codebooks = torch.from_numpy(books).to(idx.device)
        idx._publish(codes, ids, sub_list)
        idx.raw = None
        idx.ntotal = ntotal
        idx._trained = True
        return idx

    def _encode_block(self, resid: torch.Tensor) -> torch.Tensor:
        """Nearest codeword per subquantizer, in steps of ENCODE_ROWS rows
        (each row's code is independent of the step)."""
        books = self.codebooks
        b_sq = (books ** 2).sum(-1)[None]
        out = torch.empty((len(resid), self.m), dtype=torch.uint8,
                          device=resid.device)
        for s in range(0, len(resid), self.ENCODE_ROWS):
            r = resid[s:s + self.ENCODE_ROWS].view(-1, self.m, self.dsub)
            sim = 2.0 * torch.einsum("nmd,mkd->nmk", r, books) - b_sq
            out[s:s + len(r)] = sim.argmax(-1).to(torch.uint8)
        return out

    # -- search ------------------------------------------------------------
    def _decode_chunk(self, codes: torch.Tensor,
                      sub_list: torch.Tensor) -> torch.Tensor:
        return _pq_decode_chunk(codes, sub_list, self.codebooks,
                                self.centroids, lt=self.LIST_TILE)

    def _gather_pruned(self, needed: np.ndarray, lt: int):
        """Compact the probed subtiles; returns (codes, ids, sub_list,
        n_rows) that scan like the full arrays. Gather sizes are rounded up
        to a power of two of BLK-sized units."""
        sub_idx = np.where(needed)[0].astype(np.int32)
        unit = self.BLK // lt
        n_units = max(1, -(-len(sub_idx) // unit))
        n_units = 1 << (n_units - 1).bit_length()       # next pow2
        n_pad = min(n_units * unit, max(self.n_pad // lt, unit))
        if n_pad * lt >= self.n_pad:                    # nothing to save
            return self.codes, self.ids, self.sub_list, self.n_pad
        sub_idx = np.pad(sub_idx, (0, n_pad - len(sub_idx)),
                         constant_values=-1)
        c, i, s = _pq_gather_subtiles(
            self.codes, self.ids, self.sub_list,
            torch.from_numpy(sub_idx).to(self.device), lt=lt)
        return c, i, s, n_pad * lt

    def search(self, q: np.ndarray, k: int, block: int = 512,
               chunk_rows: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Chunk-major search: stage every query block (queries, the
        per-list probe bias, the running top-k), then decode each DB chunk
        once and run kernel B3 on it for every block."""
        q = np.asarray(q, np.float32)
        lt = self.LIST_TILE
        dev = self.device
        chunk = min(self.n_pad, chunk_rows or self.CHUNK_ROWS)
        chunk -= chunk % self.BLK
        chunk = max(chunk, self.BLK)
        keep = min(4 * k if self.refine else k, self.n_pad)
        blocks = []
        for s in range(0, len(q), block):
            blk = q[s:s + block]
            # only a multi-block search pads its last block (B3 therefore
            # sees any block size from 1 to `block`)
            pad = block - len(blk) if len(blk) < block and len(q) > block \
                else 0
            if pad:
                blk = np.pad(blk, ((0, pad), (0, 0)))
            qd = torch.from_numpy(np.ascontiguousarray(blk)).to(dev)
            blocks.append({
                "qd": qd, "pad": pad,
                "bias": _pq_bias_list(qd, self.centroids,
                                      nprobe=self.nprobe),  # (nq, nlist)
                "v": torch.full((len(blk), keep), -float("inf"),
                                device=dev),
                "i": torch.full((len(blk), keep), -1, dtype=torch.int32,
                                device=dev),
            })
        codes_v, ids_v, sub_v, n_scan = (self.codes, self.ids,
                                         self.sub_list, self.n_pad)
        if blocks:
            probed = blocks[0]["bias"].new_zeros(self.nlist, dtype=torch.bool)
            for b in blocks:
                probed |= _pq_probed_lists(b["bias"])
            needed = _pq_sub_needed(probed, self.sub_list)
            if needed.float().mean().item() <= self.PRUNE_COVERAGE:
                codes_v, ids_v, sub_v, n_scan = self._gather_pruned(
                    needed.cpu().numpy(), lt)
        for cs in range(0, n_scan, chunk):
            ce = min(cs + chunk, n_scan)
            sub_c = sub_v[cs // lt:ce // lt]
            dec = self._decode_chunk(codes_v[cs:ce], sub_c)
            ids_c = ids_v[cs:ce]
            for b in blocks:
                bias_c = _pq_expand_bias(b["bias"], sub_c)
                v, i = topk_ip_masked(b["qd"], dec, ids_c, bias_c, keep, lt)
                b["v"], b["i"] = _merge_topk(b["v"], b["i"], v, i)
        outs_d, outs_i = [], []
        for b in blocks:
            best_v, best_i = b["v"], b["i"]
            if self.refine:
                best_v, best_i = _pq_refine(b["qd"], self.raw, best_i, k=k)
            else:
                best_v, best_i = best_v[:, :k], best_i[:, :k]
            n = best_v.shape[0] - b["pad"]
            outs_d.append(best_v[:n].cpu().numpy())
            outs_i.append(best_i[:n].cpu().numpy())
        if not outs_d:
            return (np.zeros((0, k), np.float32), np.zeros((0, k), np.int32))
        return np.concatenate(outs_d), np.concatenate(outs_i)


def _pq_codewords(codes: torch.Tensor, books: torch.Tensor) -> torch.Tensor:
    """(C, m) codes -> (C, m * dsub) selected codewords: a gather (the JAX
    package's one-hot einsum is a matrix-unit trick for the TPU)."""
    c, m = codes.shape
    ksub, dsub = books.shape[1], books.shape[2]
    flat = codes.long() + torch.arange(m, device=codes.device) * ksub
    return books.reshape(m * ksub, dsub)[flat].reshape(c, m * dsub)


def _add_coarse(resid: torch.Tensor, sub_list: torch.Tensor,
                centroids: torch.Tensor, lt: int) -> torch.Tensor:
    """resid (C, d) f32 + the centroid of each row's list, cast to bf16;
    filler subtiles (list −1) take list 0's centroid and are masked by the
    bias."""
    coarse = centroids[sub_list.clamp(min=0).long()]          # (C // lt, d)
    resid.view(-1, lt, resid.shape[1]).add_(coarse[:, None, :])
    return resid.to(torch.bfloat16)


def _pq_decode_chunk(codes, sub_list, codebooks, centroids, *, lt):
    """decode(x) = centroid[list] + Σ_m codebook_m[code_m]: codes (C, m)
    uint8 -> (C, d) bf16. The codewords are selected in f32, which equals
    the JAX package on the CPU bit for bit (its f32 one-hot einsum selects
    exactly); on the TPU it rounds the codewords to bf16 before the centroid
    add, so the card's decode differs from the TPU's by at most that one
    rounding."""
    return _add_coarse(_pq_codewords(codes, codebooks), sub_list, centroids,
                       lt)


def _pq_bias_list(q, centroids, *, nprobe):
    """0 / NEG additive bias per (query, LIST) from the coarse probe: the
    ``nprobe`` best lists by f32 ``q · centroid`` (ties to the lower list,
    as ``jax.lax.top_k``). Expanded to subtiles chunk by chunk."""
    q_cent = q @ centroids.T
    _, probes = topk_low_index(q_cent, nprobe)
    return torch.full_like(q_cent, NEG).scatter_(1, probes, 0.0)


def _pq_expand_bias(bias_list, sub_chunk):
    """subtile -> its list's bias; filler subtiles (list −1) get NEG."""
    b = bias_list[:, sub_chunk.clamp(min=0).long()]
    return b.masked_fill(sub_chunk[None, :] < 0, NEG)


def _pq_probed_lists(bias_list):
    """(nq, nlist) additive bias -> (nlist,) bool: any query probes it."""
    return (bias_list > NEG / 2).any(0)


def _pq_sub_needed(probed, sub_list):
    """(nlist,) probed bitmap -> (n_sub,) bool per subtile (filler
    subtiles, list −1, are never needed)."""
    return probed[sub_list.clamp(min=0).long()] & (sub_list >= 0)


def _pq_gather_subtiles(codes, ids, sub_list, sub_idx, *, lt):
    """Compact the subtiles ``sub_idx`` into contiguous arrays. Pad slots
    (sub_idx −1) gather subtile 0; their list id is forced to −1, which the
    bias expansion masks like the store's own filler subtiles."""
    n_sub, m = sub_list.shape[0], codes.shape[1]
    safe = sub_idx.clamp(min=0).long()
    c = codes.view(n_sub, lt * m)[safe].view(-1, m)
    i = ids.view(n_sub, lt)[safe].view(-1)
    s = torch.where(sub_idx < 0, -1, sub_list[safe]).to(torch.int32)
    return c, i, s


def _merge_topk(best_v, best_i, v, i):
    """Running top-k of (best, new chunk); ties go to the earlier slot."""
    all_v = torch.cat([best_v, v], 1)
    all_i = torch.cat([best_i, i], 1)
    nv, sel = topk_low_index(all_v, best_v.shape[1])
    return nv, all_i.gather(1, sel)


def _pq_refine(q, raw, best_i, *, k):
    """Exact f32 rescore of the PQ shortlist with the raw vectors
    (ivfpq-rr); −inf / −1 on empty slots."""
    vecs = raw[best_i.clamp(min=0).long()]                    # (nq, keep, d)
    exact = torch.einsum("nd,nkd->nk", q, vecs)
    exact = exact.masked_fill(best_i < 0, -float("inf"))
    d2, sel = topk_low_index(exact, k)
    ids = best_i.gather(1, sel)
    return d2, torch.where(torch.isfinite(d2), ids, -1)


# ---------------------------------------------------------------------------
def cacheable_cls(index_type: str, nprobe: int = 40):
    """(cls, load_kwargs) for index types whose built store persists to /
    loads from an npz; (None, None) for the other ported types (IVF-PQ
    included, as in the JAX package). Types still to port raise
    NotImplementedError."""
    t = index_type.lower()
    if t in ("sq8", "sq8-flat"):
        return SQ8FlatIndex, {}
    if t in _LATER:
        raise _not_ported(t)
    if t in ("l2", "ip", "ivf", "ivfpq", "ivfpq-rr"):
        return None, None
    raise ValueError(index_type)


def get_index(index_type: str, train_data: np.ndarray,
              max_train: int = int(1e7), nprobe: int = 40,
              ef_search: int = 64, device: DeviceLike = None):
    """Index factory (counterpart of get_index, get_index_faiss.py:10-121).

    'l2'/'ip' exact f32; 'ivf' maps to the exact index (as in the JAX
    package); 'sq8'/'sq8-flat' the exact int8 scan; 'ivfpq' / 'ivfpq-rr'
    IVF-PQ with the reference's parameters (nlist 256, 8-bit codes), trained
    here on ``train_data`` (at most ``max_train`` rows). Every other type of
    the JAX package raises NotImplementedError naming its place in
    ROADMAP.md. ``ef_search`` belongs to hnsw, not ported yet."""
    del ef_search
    t = index_type.lower()
    d = train_data.shape[1]
    if t in ("l2", "ip", "ivf"):
        return FlatIndex(train_data, metric="l2" if t == "l2" else "ip",
                         device=device)
    if t in ("ivfpq", "ivfpq-rr"):
        # m 64 is the reference's d 128 setting (get_index_faiss.py:69-83);
        # other embedding sizes take 2 dims per subquantizer
        m = 64 if d % 64 == 0 else max(d // 2, 1)
        idx = IVFPQIndex(d=d, nlist=256, m=m, nbits=8, nprobe=nprobe,
                         refine=(t == "ivfpq-rr"), device=device)
        idx.train(train_data, max_train=max_train)
        return idx
    if t in ("sq8", "sq8-flat"):
        return SQ8FlatIndex(d=d, device=device)
    if t in _LATER:
        raise _not_ported(t)
    raise ValueError(index_type)
