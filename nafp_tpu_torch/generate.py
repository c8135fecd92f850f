"""Fingerprint generation: stream datasets through the encoder to memmaps.

Counterpart of ``nafp_tpu/generate.py`` (reference
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

``DATA_SEL.TEST_QUERY_DB: unseen_syn`` synthesizes the queries: each
batch's clean replicas are augmented on the device with the test-time
background mix and IR (``TD_AUG.TS_*``), drawing from a generator seeded
by the batch index (the JAX package keys batch i with ``PRNGKey(i)``:
the same law, not the same draws). A source the loader has no files for
is left out of the chain (the JAX package mixes zeros in its place).

``DEVICE.DEVICE_CORPUS``: every source whose songs fit
``DEVICE_CORPUS_MAX_GB`` is uploaded once and its batches are gathered on
the card (``data/device_corpus.py``); the memmaps are the same.

``DEVICE.MESH_DATA_PARALLEL`` (-1 = every local card): the pass runs over
``parallel.mesh.data_devices`` in one process, the JAX package's batch
sharding over its mesh. The model is replicated on each device, a batch's
rows are zero-padded to a multiple of the device count and split, the
log-mel max is the whole batch's (the max of the devices' maxima, as the
JAX package's one program over the mesh takes it), and the embeddings are
reassembled in row order; the pad rows land past ``n_valid``. Batches come
up to, and ``unseen_syn`` queries are synthesized on, the first device.
With one device the pass is the single-device one.
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
from nafp_tpu_torch.data.device_corpus import maybe_device_loader
from nafp_tpu_torch.data.loader import prefetch
from nafp_tpu_torch.device import DeviceLike, resolve_device
from nafp_tpu_torch.models.convert import (find_params, flax_to_torch,
                                           load_params_npz)
from nafp_tpu_torch.models.nnfp import get_fingerprinter
from nafp_tpu_torch.ops.melspec import get_melspec_fn, melspectrogram_parts
from nafp_tpu_torch.ops.tdaug import augment_replicas
from nafp_tpu_torch.parallel.mesh import data_devices
from nafp_tpu_torch.utils.profiling import span


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
    ``device`` defaults to ``cuda:0`` (raises when no card is present);
    the pass runs over ``data_devices(cfg, device)``."""
    with span("generate.setup"):
        device = resolve_device(device)
        devices = data_devices(cfg, device)
        device = devices[0]
        melspec_fn, mcfg = get_melspec_fn(cfg)
        with span("generate.load_model"):
            variables, checkpoint_index = load_params(cfg, checkpoint_name,
                                                      checkpoint_index)
            models = [build_model(cfg, variables, device)]
            if len(devices) > 1:
                print(f"[generate] fingerprint pass over {len(devices)} "
                      f"devices: {', '.join(map(str, devices))}")
                models += [build_model(cfg, variables, d)
                           for d in devices[1:]]

        def fingerprint(x: torch.Tensor) -> torch.Tensor:
            if len(devices) == 1:
                return models[0](melspec_fn(x))
            pad = (-x.shape[0]) % len(devices)
            if pad:
                x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
            parts = [c.to(d)
                     for c, d in zip(x.chunk(len(devices)), devices)]
            feats = melspectrogram_parts(parts, mcfg)
            embs = [m(f) for m, f in zip(models, feats)]  # all launched first
            return torch.cat([e.to(device) for e in embs])

        dataset = Dataset(cfg)
        ds = get_data_source(cfg, dataset, source_root_dir, skip_dummy)
        # DEVICE.DEVICE_CORPUS: each source that fits the budget is resident
        # on the card and its batches are gathered there
        # (data/device_corpus.py)
        ds = {k: maybe_device_loader(v, cfg, label=k, device=device)
              for k, v in ds.items()}

        out_root = output_root_dir or cfg["DIR"]["OUTPUT_ROOT_DIR"]
        out_dir = os.path.join(out_root, checkpoint_name,
                               str(checkpoint_index))
        os.makedirs(out_dir, exist_ok=True)
        if not skip_dummy and not source_root_dir and not assume_yes:
            prevent_overwrite("dummy_db",
                              os.path.join(out_dir, "dummy_db.mm"))

        snr = tuple(cfg["TD_AUG"]["TS_SNR"])
        use_bg = bool(cfg["TD_AUG"]["TS_BG_AUG"])
        use_ir = bool(cfg["TD_AUG"]["TS_IR_AUG"])

        def to_dev(batch, key):
            if key not in batch:
                return None
            x = batch[key]
            return (x if torch.is_tensor(x)
                    else torch.from_numpy(x).to(device))

        dim = int(cfg["MODEL"]["EMB_SZ"])
        sz_check = {}
    for key, loader in ds.items():
        synth = loader.reduce_batch_first_half  # 'unseen_syn' query loader
        n_rep = max(1, loader.n_pos_per_anchor) if synth else 1
        n_items = loader.n_samples * n_rep
        assert n_items > 0
        arr = create_memmap(out_dir, key, (n_items, dim))
        print(f"=== Generating fingerprint from '{key}' "
              f"bsz={loader.bsz}, {n_items} items, d={dim} ===")
        t0 = time.perf_counter()
        row = 0
        with torch.inference_mode():
            for i, batch in enumerate(prefetch(loader)):
                if synth:
                    gen = torch.Generator(device=device).manual_seed(i)
                    x = augment_replicas(to_dev(batch, "replicas"),
                                         to_dev(batch, "bg"),
                                         to_dev(batch, "ir"), gen, snr,
                                         use_bg=use_bg, use_ir=use_ir)
                else:
                    x = to_dev(batch, "anchors")
                emb = fingerprint(x)
                n_valid = int(batch["n_valid"]) * n_rep
                with span("generate.wait"):
                    rows = emb[:n_valid].float().cpu()
                arr[row:row + n_valid] = rows.numpy()
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
