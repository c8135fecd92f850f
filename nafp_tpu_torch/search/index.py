"""Exact vector indexes on the GPU: f32 flat and int8 flat.

Counterpart of ``nafp_tpu/search/index.py`` (``FlatIndex``,
``SQ8FlatIndex``, ``get_index``, ``cacheable_cls``), itself the replacement
of the reference's FAISS backend (``eval/utils/get_index_faiss.py``).
Fingerprints are L2-normalised, so L2 ranking equals inner-product
ranking. The approximate families (IVF-PQ, IVF-SQ8, hnsw) and the sharded
indexes are later slices and raise ``NotImplementedError`` here.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from nafp_tpu_torch.device import DeviceLike, resolve_device
from nafp_tpu_torch.search.topk import (NEG, topk_ip, topk_ip_sq8,
                                        topk_low_index)

# Index types of the JAX package that later slices port (ROADMAP.md).
_LATER = {
    "ivfpq": "slice 3 (IVF-PQ, kernel B3)",
    "ivfpq-rr": "slice 3 (IVF-PQ, kernel B3)",
    "ivf-sq8": "slice 3 (IVF-SQ8)",
    "hnsw": "slice 3 (hnsw)",
    "l2-sharded": "slice 4 (sharded search)",
    "sq8-sharded": "slice 4 (sharded search)",
    "ivf-sq8-sharded": "slice 4 (sharded search)",
}


def _not_ported(index_type: str) -> NotImplementedError:
    return NotImplementedError(
        f"index type {index_type!r} is not ported to nafp_tpu_torch yet: "
        f"{_LATER[index_type]} in ROADMAP.md. Ported: l2, ip, ivf, sq8, "
        "sq8-flat")


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
def cacheable_cls(index_type: str, nprobe: int = 40):
    """(cls, load_kwargs) for index types whose built store persists to /
    loads from an npz; (None, None) for the other ported types. Types that
    later slices port raise NotImplementedError."""
    t = index_type.lower()
    if t in ("sq8", "sq8-flat"):
        return SQ8FlatIndex, {}
    if t in _LATER:
        raise _not_ported(t)
    if t in ("l2", "ip", "ivf"):
        return None, None
    raise ValueError(index_type)


def get_index(index_type: str, train_data: np.ndarray,
              max_train: int = int(1e7), nprobe: int = 40,
              ef_search: int = 64, device: DeviceLike = None):
    """Index factory (counterpart of get_index, get_index_faiss.py:10-121).

    'l2'/'ip' exact f32; 'ivf' maps to the exact index (as in the JAX
    package); 'sq8'/'sq8-flat' the exact int8 scan. Every other type of the
    JAX package raises NotImplementedError naming its slice: the CLI's
    default '-i ivfpq' fails loudly and never falls back to another index.
    ``max_train``, ``nprobe`` and ``ef_search`` belong to the later
    families."""
    del max_train, nprobe, ef_search
    t = index_type.lower()
    if t in ("l2", "ip", "ivf"):
        return FlatIndex(train_data, metric="l2" if t == "l2" else "ip",
                         device=device)
    if t in ("sq8", "sq8-flat"):
        return SQ8FlatIndex(d=train_data.shape[1], device=device)
    if t in _LATER:
        raise _not_ported(t)
    raise ValueError(index_type)
