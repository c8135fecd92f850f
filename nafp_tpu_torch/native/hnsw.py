"""ctypes wrapper for the native HNSW index (``native/hnsw.cc``).

Counterpart of ``nafp_tpu/native/hnsw.py``, over the port's own copy of
the C++ source. The API matches the other indexes (``add`` / ``search``);
the reference's faiss ``IndexHNSWFlat`` took M 16 (get_index_faiss.py:
88-96). The index lives on the host by nature (graph pointer-chasing), as
the reference's CPU-only faiss index does.

The library is built with g++ at first use into ``nafp_tpu_torch/_build/``
(listed in ``.gitignore``), as ``native/__init__.py`` builds ``wavio``.
There is no Python fallback: a failed build raises.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from typing import Optional, Tuple

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "hnsw.cc")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                          "_build")
_SO = os.path.join(_BUILD_DIR, "_hnsw.so")
_lib: Optional[ctypes.CDLL] = None


def _build() -> None:
    # -ffast-math: the file is dot products and comparisons (no NaN/inf
    # semantics to keep), and it vectorizes the reduction. -march=native is
    # safe: a binary moved to another host fails to load and is rebuilt.
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", "-O3", "-march=native", "-ffast-math",
                        "-shared", "-fPIC", "-std=c++17", "-pthread", _SRC,
                        "-o", tmp], check=True, capture_output=True,
                       timeout=180)
        os.replace(tmp, _SO)   # atomic: concurrent builders never see half
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_SO) or (os.path.getmtime(_SO)
                                   < os.path.getmtime(_SRC)):
        _build()
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        # a binary from another platform: rebuild once for this host
        _build()
        lib = ctypes.CDLL(_SO)
    lib.hnsw_create.restype = ctypes.c_void_p
    lib.hnsw_create.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                ctypes.c_uint64]
    lib.hnsw_add.argtypes = [ctypes.c_void_p,
                             ctypes.POINTER(ctypes.c_float), ctypes.c_int]
    lib.hnsw_size.restype = ctypes.c_int
    lib.hnsw_size.argtypes = [ctypes.c_void_p]
    lib.hnsw_dim.restype = ctypes.c_int
    lib.hnsw_dim.argtypes = [ctypes.c_void_p]
    lib.hnsw_search.argtypes = [ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_float),
                                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                ctypes.POINTER(ctypes.c_int64),
                                ctypes.POINTER(ctypes.c_float)]
    lib.hnsw_add_parallel.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_float),
                                      ctypes.c_int, ctypes.c_int]
    lib.hnsw_save.restype = ctypes.c_int
    lib.hnsw_save.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.hnsw_load.restype = ctypes.c_void_p
    lib.hnsw_load.argtypes = [ctypes.c_char_p]
    lib.hnsw_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


class HNSWIndex:
    def __init__(self, d: int, m: int = 16, ef_construction: int = 80,
                 ef_search: int = 64, seed: int = 0):
        self._lib = _load()
        self._h = self._lib.hnsw_create(d, m, ef_construction, seed)
        self.d = d
        self.ef_search = ef_search

    @property
    def ntotal(self) -> int:
        return self._lib.hnsw_size(self._h)

    def add(self, data: np.ndarray, threads: int = 1) -> None:
        """Bulk insert. ``threads > 1`` (or 0 = hardware concurrency) uses
        the lock-striped parallel builder, as faiss parallelizes its HNSW
        add."""
        data = np.ascontiguousarray(data, np.float32)
        if data.ndim != 2 or data.shape[1] != self.d:
            raise ValueError(f"expected (n, {self.d}) rows, got {data.shape}")
        ptr = data.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        if threads == 1:
            self._lib.hnsw_add(self._h, ptr, len(data))
        else:
            self._lib.hnsw_add_parallel(self._h, ptr, len(data), threads)

    def save(self, path: str) -> None:
        """Persist the graph and vectors (binary, versioned; the JAX
        package's format)."""
        rc = self._lib.hnsw_save(self._h, path.encode())
        if rc != 0:
            raise IOError(f"hnsw_save({path}) failed with rc={rc}")

    @classmethod
    def load(cls, path: str, ef_search: int = 64) -> "HNSWIndex":
        lib = _load()
        h = lib.hnsw_load(path.encode())
        if not h:
            raise IOError(f"hnsw_load({path}) failed (missing/corrupt)")
        idx = cls.__new__(cls)
        idx._lib = lib
        idx._h = h
        idx.ef_search = ef_search
        idx.d = lib.hnsw_dim(h)   # from the file header
        return idx

    def search(self, q: np.ndarray, k: int,
               ef_search: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        q = np.ascontiguousarray(q, np.float32)
        nq = len(q)
        ids = np.full((nq, k), -1, np.int64)
        scores = np.full((nq, k), -1e30, np.float32)
        if self.ntotal == 0:
            return scores, ids
        self._lib.hnsw_search(
            self._h, q.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            nq, k, ef_search or self.ef_search,
            ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        return scores, ids

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.hnsw_free(self._h)
            self._h = None
