"""Fingerprint generation: stream datasets through the encoder to memmaps.

Counterpart of ``nafp_tpu/generate.py`` on one device (reference
``model/generate.py:91-194``). Same on-disk contract:
``{dummy_db,db,query,custom_source}.mm`` float32 (n_items, d) plus
``{key}_shape.npy`` under ``OUTPUT_ROOT_DIR/CHECKPOINT_NAME/INDEX/``, so
evaluation in either package reads either package's output.

Weights come from ``LOG_ROOT_DIR/checkpoint/NAME/INDEX/params.npz`` (the
Flax variables exported with numpy; see ``models/convert.py``).

Batches are the loader's static ``TS_BATCH_SZ`` rows, the last one
zero-padded with ``n_valid`` real rows: the log-mel max is taken over the
whole batch, so the same batches reproduce the JAX package's memmaps.
Exactly ``n_valid`` rows per batch are written.
"""
from __future__ import annotations

import os
import sys
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from nafp_tpu_torch.data.audio_io import create_memmap
from nafp_tpu_torch.data.catalog import Dataset
from nafp_tpu_torch.data.loader import prefetch
from nafp_tpu_torch.device import DeviceLike, resolve_device
from nafp_tpu_torch.models.convert import (find_params, flax_to_torch,
                                           load_params_npz)
from nafp_tpu_torch.models.nnfp import get_fingerprinter
from nafp_tpu_torch.ops.melspec import get_melspec_fn


def load_params(cfg: Dict[str, Any], checkpoint_name: str,
                checkpoint_index: Optional[int]):
    """(Flax-layout variables, checkpoint index) from ``params.npz``; the
    newest index when ``checkpoint_index`` is None."""
    path, index = find_params(cfg, checkpoint_name, checkpoint_index)
    return load_params_npz(path), index


def prevent_overwrite(key: str, target_path: str) -> None:
    """Interactive guard for the expensive dummy-db pass
    (reference generate.py:55-58)."""
    if key == "dummy_db" and os.path.exists(target_path):
        answer = input(f"{target_path} exists. Will you overwrite (y/N)? ")
        if answer.lower() not in ("y", "yes"):
            sys.exit()


def get_data_source(cfg, dataset: Dataset, source_root_dir, skip_dummy):
    ds = {}
    if source_root_dir:
        ds["custom_source"] = dataset.get_custom_db_ds(source_root_dir)
    else:
        if skip_dummy:
            print("Excluding 'dummy_db' from source.")
        else:
            ds["dummy_db"] = dataset.get_test_dummy_db_ds()
        ds["query"], ds["db"] = dataset.get_test_query_db_ds()
    print(f"Data source: {list(ds.keys())} ({dataset.datasel_test_query_db})")
    return ds


def build_model(cfg: Dict[str, Any], variables, device: torch.device):
    """The FingerPrinter with converted weights, in eval mode on device."""
    model = get_fingerprinter(cfg)
    model.load_state_dict(flax_to_torch(variables), strict=True)
    return model.to(device).eval()


def generate_fingerprint(cfg: Dict[str, Any],
                         checkpoint_name: str,
                         checkpoint_index: Optional[int] = None,
                         source_root_dir: Optional[str] = None,
                         output_root_dir: Optional[str] = None,
                         skip_dummy: bool = False,
                         assume_yes: bool = False,
                         device: DeviceLike = None) -> str:
    """Write the fingerprint memmaps; returns the output directory.
    ``device`` defaults to ``cuda:0`` (raises when no card is present)."""
    device = resolve_device(device)
    if cfg.get("DEVICE", {}).get("DEVICE_CORPUS"):
        raise NotImplementedError(
            "DEVICE.DEVICE_CORPUS (device-resident audio corpus) is not "
            "ported yet (the training slice, ROADMAP.md item 8); set it to False")
    melspec_fn, _ = get_melspec_fn(cfg)
    variables, checkpoint_index = load_params(cfg, checkpoint_name,
                                              checkpoint_index)
    model = build_model(cfg, variables, device)

    dataset = Dataset(cfg)
    ds = get_data_source(cfg, dataset, source_root_dir, skip_dummy)

    out_root = output_root_dir or cfg["DIR"]["OUTPUT_ROOT_DIR"]
    out_dir = os.path.join(out_root, checkpoint_name, str(checkpoint_index))
    os.makedirs(out_dir, exist_ok=True)
    if not skip_dummy and not source_root_dir and not assume_yes:
        prevent_overwrite("dummy_db", os.path.join(out_dir, "dummy_db.mm"))

    dim = int(cfg["MODEL"]["EMB_SZ"])
    sz_check = {}
    for key, loader in ds.items():
        n_items = loader.n_samples
        assert n_items > 0
        arr = create_memmap(out_dir, key, (n_items, dim))
        print(f"=== Generating fingerprint from '{key}' "
              f"bsz={loader.bsz}, {n_items} items, d={dim} ===")
        t0 = time.perf_counter()
        row = 0
        with torch.inference_mode():
            for batch in prefetch(loader):
                x = torch.from_numpy(batch["anchors"]).to(device)
                emb = model(melspec_fn(x))
                n_valid = int(batch["n_valid"])
                arr[row:row + n_valid] = emb[:n_valid].float().cpu().numpy()
                row += n_valid
        arr.flush()
        del arr
        secs = time.perf_counter() - t0
        print(f"=== Stored {n_items} fingerprints to {out_dir} "
              f"({n_items / max(secs, 1e-9):.1f} segments/s on {device}) ===")
        sz_check[key] = n_items

    if "db" in sz_check and sz_check["db"] != sz_check.get("query"):
        print("Warning: 'db' and 'query' sizes differ; evaluation may break.")
    return out_dir
