"""Carry FingerPrinter weights from the Flax layout to the port's modules.

A JAX checkpoint's variables are a nested dict ``{"params": ...,
["batch_stats": ...]}`` (what ``nafp_tpu.generate.load_params`` returns).
Exported with numpy as a ``params.npz`` whose keys are the ``/``-joined
paths (``params/conv_layer_0/conv_1x3/kernel``), they load here without
JAX or orbax: see README ("Exporting a JAX checkpoint").

Layout changes: conv kernels HWIO -> OIHW; layer_norm2d gamma/beta
(F,T,C) -> (C,F,T); everything else (biases, layer_norm1d/batch_norm
vectors, DivEnc ``w1 b1 w2 b2``) as is.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

# Flax norm-module kind -> {Flax leaf: port leaf}
_NORM_NAMES = {
    "LayerNorm2d": {"gamma": "gamma", "beta": "beta"},
    "LayerNorm": {"scale": "scale", "bias": "bias"},
    "BatchNorm": {"scale": "scale", "bias": "bias"},
}
_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}


def _norm_slot(flax_name: str) -> Tuple[str, str]:
    """'LayerNorm2d_1' -> ('LayerNorm2d', 'norm_2')."""
    kind, idx = flax_name.rsplit("_", 1)
    if kind not in _NORM_NAMES:
        raise KeyError(f"unknown Flax norm module {flax_name!r}")
    return kind, f"norm_{int(idx) + 1}"


def flax_to_torch(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax variables (nested dicts of arrays) -> the port's state_dict."""
    out: Dict[str, torch.Tensor] = {}

    def put(key, arr):
        out[key] = torch.from_numpy(np.ascontiguousarray(
            np.asarray(arr, np.float32)))

    for lname, layer in variables["params"].items():
        if lname == "div_enc":
            for leaf in ("w1", "b1", "w2", "b2"):
                put(f"div_enc.{leaf}", layer[leaf])
            continue
        i = int(lname.rsplit("_", 1)[1])              # conv_layer_{i}
        pre = f"conv_layers.{i}"
        for mname, mod in layer.items():
            if mname in ("conv_1x3", "conv_3x1"):
                put(f"{pre}.{mname}.weight",
                    np.transpose(np.asarray(mod["kernel"]), (3, 2, 0, 1)))
                put(f"{pre}.{mname}.bias", mod["bias"])
                continue
            kind, slot = _norm_slot(mname)
            for leaf, tleaf in _NORM_NAMES[kind].items():
                arr = np.asarray(mod[leaf])
                if kind == "LayerNorm2d":
                    arr = np.transpose(arr, (2, 0, 1))  # (F,T,C) -> (C,F,T)
                put(f"{pre}.{slot}.{tleaf}", arr)
    for lname, layer in variables.get("batch_stats", {}).items():
        pre = f"conv_layers.{int(lname.rsplit('_', 1)[1])}"
        for mname, mod in layer.items():
            _, slot = _norm_slot(mname)
            for leaf, tleaf in _STAT_NAMES.items():
                put(f"{pre}.{slot}.{tleaf}", mod[leaf])
    return out


def unflatten(flat: Mapping[str, np.ndarray], sep: str = "/") -> Dict:
    """``{'a/b/c': x}`` -> ``{'a': {'b': {'c': x}}}``."""
    tree: Dict[str, Any] = {}
    for key, val in flat.items():
        node = tree
        *parents, leaf = key.split(sep)
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = val
    return tree


def flatten(tree: Mapping[str, Any], sep: str = "/",
            prefix: str = "") -> Dict[str, np.ndarray]:
    """Inverse of :func:`unflatten` (numpy leaves)."""
    flat: Dict[str, np.ndarray] = {}
    for key, val in tree.items():
        path = f"{prefix}{sep}{key}" if prefix else key
        if isinstance(val, Mapping):
            flat.update(flatten(val, sep, path))
        else:
            flat[path] = np.asarray(val)
    return flat


def load_params_npz(path: str) -> Dict[str, Any]:
    """Read a ``params.npz`` of ``/``-joined Flax paths into nested dicts."""
    with np.load(path) as z:
        return unflatten({k: z[k] for k in z.files})


def save_params_npz(path: str, variables: Mapping[str, Any]) -> None:
    """Write Flax-layout variables as a ``params.npz`` (the inverse of
    :func:`load_params_npz`)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flatten(variables))


def find_params(cfg: Dict[str, Any], checkpoint_name: str,
                checkpoint_index: Optional[int]) -> Tuple[str, int]:
    """Path of ``LOG_ROOT_DIR/checkpoint/NAME/INDEX/params.npz`` (the
    directory the JAX package's ExperimentHelper writes its steps into) and
    its index; the newest index holding a ``params.npz`` when
    ``checkpoint_index`` is None."""
    ckpt = os.path.abspath(os.path.join(cfg["DIR"]["LOG_ROOT_DIR"],
                                        "checkpoint", checkpoint_name))
    if checkpoint_index is None:
        found = [int(d) for d in (os.listdir(ckpt) if os.path.isdir(ckpt)
                                  else [])
                 if d.isdigit()
                 and os.path.exists(os.path.join(ckpt, d, "params.npz"))]
        if not found:
            raise FileNotFoundError(f"no params.npz checkpoint in {ckpt}")
        checkpoint_index = max(found)
        print(f"[generate] using latest checkpoint index {checkpoint_index}")
    path = os.path.join(ckpt, str(int(checkpoint_index)), "params.npz")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} missing: export the JAX checkpoint's params to it "
            "(README, 'Exporting a JAX checkpoint')")
    return path, int(checkpoint_index)
