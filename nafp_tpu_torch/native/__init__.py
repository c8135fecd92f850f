"""Native (C++) runtime components, loaded via ctypes.

``wavio``: threaded PCM16 WAV segment decoder. Built on first use with g++
into ``nafp_tpu_torch/_build/`` (listed in ``.gitignore``); every consumer
must handle ``wavio_lib()`` returning None and use the pure-Python decoder
instead (both decode to identical arrays). This is host-side audio IO: no
device kernel lives here.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from typing import Optional

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "wavio.cc")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                          "_build")
_SO = os.path.join(_BUILD_DIR, "_wavio.so")
_lib = None
_tried = False


def _build() -> bool:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", "-pthread",
             _SRC, "-o", tmp],
            check=True, capture_output=True, timeout=120)
        os.replace(tmp, _SO)   # atomic: concurrent builders never see half
        return True
    except (OSError, subprocess.SubprocessError) as e:
        print(f"[native] wavio build failed ({e}); using python decoder")
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def wavio_lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, building it on demand; None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_SO) or (os.path.getmtime(_SO)
                                   < os.path.getmtime(_SRC)):
        if not _build():
            return None
    try:
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            # Incompatible binary (built on another platform/arch):
            # rebuild once for this host before giving up.
            if not _build():
                return None
            lib = ctypes.CDLL(_SO)
        lib.nafp_load_segments.restype = ctypes.c_int
        lib.nafp_load_segments.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int]
        lib.nafp_wav_info.restype = ctypes.c_int
        lib.nafp_wav_info.argtypes = [ctypes.c_char_p,
                                      ctypes.POINTER(ctypes.c_int64),
                                      ctypes.POINTER(ctypes.c_int32)]
        _lib = lib
    except OSError as e:
        print(f"[native] wavio load failed ({e}); using python decoder")
    return _lib


def load_segments_native(paths, starts, seg_len: int,
                         n_threads: int = 4) -> Optional[np.ndarray]:
    """Batch-decode segments; returns (n, seg_len) float32 or None if the
    native lib is unavailable. Raises on decode failure (bad file)."""
    lib = wavio_lib()
    if lib is None:
        return None
    n = len(paths)
    out = np.empty((n, seg_len), np.float32)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    c_starts = np.ascontiguousarray(np.asarray(starts, np.int64))
    rc = lib.nafp_load_segments(
        c_paths, c_starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n, seg_len, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n_threads)
    if rc != 0:
        raise IOError(f"native decode failed for {paths[-rc - 1]!r}")
    return out
