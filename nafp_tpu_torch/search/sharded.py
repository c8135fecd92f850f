"""Sharded search: the flat f32, flat int8 and IVF-SQ8 indexes with their
rows split over several devices.

Counterpart of ``nafp_tpu/search/sharded.py``. The JAX package shards the
DB rows over its ``('data',)`` mesh with ``shard_map``; here one process
holds a list of devices, one shard per entry (FAISS ``IndexShards``'
model). The default list is every local card (``[cpu]`` on the CPU); an
explicit list may repeat a device, which puts several shards on one card
(or on the CPU). Each shard is a single-device index on its device, and a
sharded index is a ``BlockSearch`` whose query block is: the block on the
first device, every shard's block (all launched before any result is
read), the R k-sized candidate sets brought to the first device and merged
there with one top-k over the R·k candidates (``_merge``). Ties go to the
lower shard, and within a shard to the lower row, so the flat indexes
break ties by the lower row as the single-device ones do.

- ``ShardedFlatIndex``: contiguous row ranges, each a ``FlatIndex`` (its
  own route: kernel B1 at ``FlatIndex.PALLAS_MIN_ROWS`` rows a shard and
  above).
- ``ShardedSQ8FlatIndex``: the int8 store padded to a multiple of R ×
  ``BLK`` rows and split into R equal ``SQ8FlatIndex`` shards (kernel B2).
- ``ShardedIVFSQ8Index``: within each inverted list, row j goes to shard
  j mod R; each shard is an ``IVFSQ8Index`` store scanning
  ``ceil(cap/R)`` rows per probed list.

Stores interchange: each class persists the single-device ``.npz`` format
(``SQ8FlatIndex`` / ``IVFSQ8Index``, the JAX package's keys), and loads a
store written by its single-device twin or by either package, at any R.

There is no sharded IVF-PQ, as in the JAX package (its docstring gives the
traffic argument): per row scanned, IVF-PQ's decode moves more bytes than
the int8 scan, and sharding divides rows alike for both.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from nafp_tpu_torch.device import DeviceLike, chunked_device_put
from nafp_tpu_torch.parallel.mesh import local_devices
from nafp_tpu_torch.search.index import (BlockSearch, FlatIndex, IVFSQ8Index,
                                         SQ8FlatIndex, _pad_sq8_store,
                                         _quantize_sq8_host)
from nafp_tpu_torch.search.topk import topk_low_index
from nafp_tpu_torch.utils.profiling import spanned

Devices = Optional[Sequence[DeviceLike]]


def shard_devices(devices: Devices = None,
                  device: DeviceLike = None) -> List[torch.device]:
    """The shards' devices: ``devices`` when given, else every local card
    (``cuda:0``'s host by default), or ``[cpu]`` for a CPU ``device``."""
    if devices is not None:
        out = [torch.device(d) for d in devices]
        if not out:
            raise ValueError("a sharded index needs at least one device")
        return out
    return local_devices(device)


def _merge(parts: List[Tuple[torch.Tensor, torch.Tensor]], k: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top ``min(k, R·k')`` of R shards' (scores, ids) candidate sets,
    on the first shard's device; ties to the lower shard."""
    dev = parts[0][0].device
    v = torch.cat([p[0].to(dev) for p in parts], dim=1)
    i = torch.cat([p[1].to(dev) for p in parts], dim=1)
    vv, sel = topk_low_index(v, min(k, v.shape[1]))
    return vv, i.gather(1, sel)


class ShardedFlatIndex(BlockSearch):
    """Exact inner-product search over row-range shards of an f32 DB.

    Shard r holds rows ``[r·S, (r+1)·S)``, S = ceil(N/R), in a
    ``FlatIndex(metric='ip')`` on its device; scores are inner products,
    as the JAX package's ``ShardedFlatIndex`` returns. The results equal
    ``FlatIndex(db, 'ip')``'s. A query block is the smallest of the
    shards' blocks."""

    def __init__(self, db: np.ndarray, devices: Devices = None,
                 device: DeviceLike = None):
        self.devices = shard_devices(devices, device)
        self.device = self.devices[0]
        r = len(self.devices)
        n = len(db)
        self.ntotal = n
        self.shard_size = -(-n // r) if n else 0
        self.offsets = [min(j * self.shard_size, n) for j in range(r)]
        self.shards = [FlatIndex(db[o:o + self.shard_size], metric="ip",
                                 device=d)
                       for o, d in zip(self.offsets, self.devices)]

    def block_rows(self, block: int) -> int:
        return min(s.block_rows(block) for s in self.shards)

    def search_block(self, qd: torch.Tensor, k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        parts = []
        for shard, off in zip(self.shards, self.offsets):
            v, pos = shard.search_block(qd.to(shard.device), k)
            parts.append((v, torch.where(pos < 0, -1, pos.long() + off)))
        return _merge(parts, k)

    @spanned("index.search")
    def search(self, q: np.ndarray, k: int,
               block: int = 2048) -> Tuple[np.ndarray, np.ndarray]:
        return self._host(q, k, block)


class ShardedSQ8FlatIndex(BlockSearch):
    """Exact int8 full scan with the store split over the devices.

    The store (``SQ8FlatIndex``'s: int8 rows, f32 scales, int32 ids, −1 on
    pad rows) is padded to a multiple of R × ``BLK`` rows and cut into R
    equal shards, each an ``SQ8FlatIndex`` on its device scanned by kernel
    B2 (``topk_ip_sq8``); the R candidate sets are merged."""

    BLK = SQ8FlatIndex.BLK

    def __init__(self, d: int = 128, devices: Devices = None,
                 device: DeviceLike = None):
        self.d = d
        self.devices = shard_devices(devices, device)
        self.device = self.devices[0]
        self.ntotal = 0

    def train(self, data, **_) -> None:    # factory-contract no-op
        pass

    def add(self, data, block: int = 1 << 20,
            persist_path: Optional[str] = None) -> None:
        """Quantize on the host, optionally persist (``SQ8FlatIndex``'s
        format), split and upload."""
        q8, scales, ids = _quantize_sq8_host(
            data, len(self.devices) * self.BLK, block)
        self.ntotal = len(data)
        if persist_path:
            np.savez(persist_path, ntotal=self.ntotal, vecs8=q8,
                     scales=scales, ids=ids)
        self._publish(q8, scales, ids)

    def _publish(self, q8: np.ndarray, scales: np.ndarray,
                 ids: np.ndarray) -> None:
        r = len(self.devices)
        q8, scales, ids = _pad_sq8_store(q8, scales, ids, r * self.BLK)
        rows = len(q8) // r
        self.shards = []
        for j, dev in enumerate(self.devices):
            sl = slice(j * rows, (j + 1) * rows)
            shard = SQ8FlatIndex(d=self.d, device=dev)
            shard.ntotal = int((ids[sl] >= 0).sum())
            shard._publish(q8[sl], scales[sl], ids[sl])
            self.shards.append(shard)

    @classmethod
    def load(cls, path: str, devices: Devices = None,
             device: DeviceLike = None) -> "ShardedSQ8FlatIndex":
        """Load a store persisted by this class, ``SQ8FlatIndex`` or
        ``IVFSQ8Index`` (its list-sorted rows and their ids are what a
        full scan needs), by either package, repadded for this R."""
        with np.load(path) as z:
            q8, scales, ids = z["vecs8"], z["scales"], z["ids"]
            ntotal = int(z["ntotal"])
        idx = cls(d=q8.shape[1], devices=devices, device=device)
        idx.ntotal = ntotal
        idx._publish(q8, scales, ids)
        return idx

    def block_rows(self, block: int) -> int:
        return self.shards[0].block_rows(block)

    def search_block(self, qd: torch.Tensor, k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        v, i = _merge([s.search_block(qd.to(s.device), k)
                       for s in self.shards], k)
        return v, torch.where(i >= 0, i, -1)

    @spanned("index.search")
    def search(self, q: np.ndarray, k: int,
               block: int = 1024) -> Tuple[np.ndarray, np.ndarray]:
        return self._host(q, k, block)


class ShardedIVFSQ8Index(IVFSQ8Index):
    """IVF-SQ8 with every inverted list dealt round-robin over the devices.

    Within each coarse list, row j goes to shard j mod R; each shard is an
    ``IVFSQ8Index`` store on its device holding its share of every list
    contiguously (list order), padded by ``list_cap = ceil(cap/R)`` rows.
    A query block is probed once on the first device (the f32 coarse
    probe, ties to the lower list), each shard scans ``list_cap`` rows per
    probed list and takes its top-k (``IVFSQ8Index.scan_block``), and the
    candidate sets are merged; −1 where the score is not finite. Every
    probed row is scanned once, as in the single-device index."""

    def __init__(self, d: int = 128, nlist: Optional[int] = None,
                 nprobe: int = 40, devices: Devices = None,
                 device: DeviceLike = None):
        devs = shard_devices(devices, device)
        super().__init__(d=d, nlist=nlist, nprobe=nprobe, device=devs[0])
        self.devices = devs

    def add(self, data, block: int = 1 << 20,
            persist_path: Optional[str] = None) -> None:
        """Quantize on the host, assign each row to its list from its int8
        form on the first device (the single-device index's arithmetic),
        optionally persist the list-sorted store in ``IVFSQ8Index``'s
        format, deal and upload."""
        if not self._trained:
            raise RuntimeError("train() before add()")
        n = len(data)
        q8, scales, _ = _quantize_sq8_host(data, 1, block)
        assign = self._assign(q8, scales)
        counts = np.bincount(assign, minlength=self.nlist)
        cap = int(max(1, counts.max()))
        order = np.argsort(assign, kind="stable")
        q8, scales = q8[order], scales[order]
        ids = order.astype(np.int32)
        self.ntotal = n
        if persist_path:
            starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
            tail = lambda a, fill: np.concatenate(
                [a, np.full((cap,) + a.shape[1:], fill, a.dtype)])
            np.savez(persist_path, nlist=self.nlist, list_cap=cap,
                     ntotal=n, centroids=self.centroids.cpu().numpy(),
                     vecs8=tail(q8, 0), scales=tail(scales, 0),
                     starts=starts.astype(np.int32), ids=tail(ids, -1))
        self._publish_sharded(q8, scales, ids, counts, cap)

    def _publish_sharded(self, q8_sorted: np.ndarray,
                         scales_sorted: np.ndarray, ids_sorted: np.ndarray,
                         counts: np.ndarray, cap_global: int) -> None:
        """Deal a list-sorted store over the shards: within each list, row
        j to shard j mod R, each shard's share of every list contiguous."""
        r = len(self.devices)
        n = len(q8_sorted)
        starts_g = np.concatenate([[0], np.cumsum(counts)[:-1]])
        pos_in_list = np.arange(n) - np.repeat(starts_g, counts)
        shard_of_row = pos_in_list % r
        self.list_cap = -(-cap_global // r)
        # rows of list l on shard j: |{x in [0, counts[l]) : x mod R == j}|
        local_counts = [np.maximum(counts - j + r - 1, 0) // r
                        for j in range(r)]
        l_max = int(max(c.sum() for c in local_counts)) + self.list_cap
        self.shards = []
        for j, dev in enumerate(self.devices):
            sel = shard_of_row == j            # already in (list, pos) order
            nr = int(sel.sum())
            vecs8 = np.zeros((l_max, self.d), np.int8)
            scales = np.zeros(l_max, np.float32)
            ids = np.full(l_max, -1, np.int32)
            vecs8[:nr] = q8_sorted[sel]
            scales[:nr] = scales_sorted[sel]
            ids[:nr] = ids_sorted[sel]
            shard = IVFSQ8Index(d=self.d, nlist=self.nlist,
                                nprobe=self.nprobe, device=dev)
            shard.ntotal, shard.list_cap = nr, self.list_cap
            shard.vecs8 = chunked_device_put(vecs8, dev)
            shard._publish_meta(scales, np.concatenate(
                [[0], np.cumsum(local_counts[j])[:-1]]), ids)
            self.shards.append(shard)

    @classmethod
    def load(cls, path: str, nprobe: int = 40, devices: Devices = None,
             device: DeviceLike = None) -> "ShardedIVFSQ8Index":
        """Load an ``IVFSQ8Index`` store (persisted by this class or the
        single-device index, by either package); the round-robin layout is
        rebuilt from the list-sorted rows, at any R."""
        with np.load(path) as z:
            cents = z["centroids"]
            idx = cls(d=int(cents.shape[1]), nlist=int(z["nlist"]),
                      nprobe=nprobe, devices=devices, device=device)
            n = int(z["ntotal"])
            starts = np.asarray(z["starts"], np.int64)
            counts = np.diff(np.append(starts, n))
            idx.centroids = torch.from_numpy(cents).to(idx.device)
            idx._trained = True
            idx.ntotal = n
            idx._publish_sharded(z["vecs8"][:n],
                                 np.asarray(z["scales"][:n], np.float32),
                                 np.asarray(z["ids"][:n], np.int32), counts,
                                 int(z["list_cap"]))
        return idx

    def search_block(self, qd: torch.Tensor, k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        probes = self.probe(qd)
        v, i = _merge([s.scan_block(qd.to(s.device), probes.to(s.device), k)
                       for s in self.shards], k)
        return v, torch.where(torch.isfinite(v), i, -1).to(torch.int32)
