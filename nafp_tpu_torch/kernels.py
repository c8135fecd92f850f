"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into ``_build/lib<name>.so`` at first use, then
loaded with ``ctypes``: no PyTorch headers, so a build takes seconds. The
build directory is listed in ``.gitignore``; a library older than its
source or any header of ``csrc/`` is rebuilt. Nothing here runs at import
time.
"""
from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
KERNELS = ("topk_f32", "topk_sq8", "topk_masked", "bench_variant",
           "bench_dotonly", "layernorm2d", "lamb")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    """Path of nvcc: ``$NVCC``, then PATH, then ``/usr/local/cuda``."""
    cands = [os.environ.get("NVCC"), shutil.which("nvcc"),
             "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels are compiled at "
                       "first use and need the CUDA toolkit")


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _sources(name: str):
    """The files library ``name`` is built from: its source and every
    header of ``csrc/`` (any of them may be included)."""
    return [os.path.join(CSRC, f"{name}.cu")] + sorted(
        glob.glob(os.path.join(CSRC, "*.cuh")))


def _stale(name: str) -> bool:
    so = library_path(name)
    return (not os.path.exists(so) or os.path.getmtime(so)
            < max(os.path.getmtime(s) for s in _sources(name)))


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile the named kernels (all by default) that are missing or
    stale, one nvcc process per source, all started together. Returns
    {name: compiler log} for what was built; raises with the log on any
    failure."""
    names = list(KERNELS if names is None else names)
    todo = [n for n in names if _stale(n)]
    if not todo:
        return {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    exe = nvcc()
    procs = {}
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [exe, *NVCC_FLAGS, "-I", CSRC, "-o", tmp,
               os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    logs, failed = {}, []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode == 0:
            os.replace(tmp, library_path(name))  # atomic for other builders
        else:
            failed.append(name)
            os.remove(tmp)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(library_path(name))
            _libs[name] = lib
        return lib


def function(name: str, argtypes, suffix: str = "") -> ctypes._CFuncPtr:
    """The C entry point ``nafp_<name><suffix>`` of kernel library ``name``
    (built and loaded first if needed) with its argument types set; it
    returns a CUDA error code, 0 on success."""
    fn = getattr(load(name), f"nafp_{name}{suffix}")
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


OCCUPANCY_SLOTS = 8   # ints an occupancy query may write (B1 writes 6)


def occupancy(name: str, *args: int, n_out: int = 3) -> List[int]:
    """What ``nafp_<name>_occupancy(*args, info)`` of kernel library
    ``name`` writes into info[0 .. n_out-1], for the current CUDA device:
    a scan's shared memory per CTA in bytes, the CTAs one SM holds, its
    registers per thread (for B4b, then the CTAs of its grid; for B1, its
    queries per CTA, local memory per thread in bytes and ring stages)."""
    fn = getattr(load(name), f"nafp_{name}_occupancy")
    fn.argtypes = [ctypes.c_int] * len(args) + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    info = (ctypes.c_int * OCCUPANCY_SLOTS)()
    err = fn(*args, info)
    if err:
        raise RuntimeError(f"nafp_{name}_occupancy{args}: CUDA error {err}")
    return list(info)[:n_out]


def all_on_cpu(*ts) -> bool:
    """True when every tensor is on the CPU (the callers' plain route),
    False when all are on one CUDA device (the kernels' route); raises
    for tensors on mixed devices or on any other device."""
    devs = {t.device.type for t in ts}
    if len(devs) != 1:
        raise ValueError(f"tensors on mixed devices: {sorted(devs)}")
    if devs == {"cpu"}:
        return True
    if devs != {"cuda"} or len({t.device for t in ts}) != 1:
        raise ValueError(f"unsupported devices {[str(t.device) for t in ts]}")
    return False


def build_all() -> Tuple[float, Dict[str, str]]:
    """Build every kernel now (in parallel) and load it; returns (seconds,
    {name: compiler log} of what was compiled)."""
    t0 = time.perf_counter()
    logs = build()
    for name in KERNELS:
        load(name)
    return time.perf_counter() - t0, logs
