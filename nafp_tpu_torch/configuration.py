"""Configuration loading & validation.

Keeps the reference's YAML contract (section keys ``DIR``, ``DATA_SEL``,
``MODEL``, ``BSZ``, ``TRAIN``, ``LOSS``, ``TD_AUG``, ``SPEC_AUG``, ``DEVICE``;
see reference ``config/default.yaml:2-109`` and ``run.py:13-34``) but adds a
schema check so typos fail fast instead of being read ad-hoc at use sites.
"""
from __future__ import annotations

import os
import sys
from typing import Any, Dict

import yaml

# Required sections and a few required keys per section. We deliberately do
# not lock the full key set: presets may carry extra tuning knobs.
_REQUIRED: Dict[str, tuple] = {
    "DIR": ("SOURCE_ROOT_DIR", "OUTPUT_ROOT_DIR", "LOG_ROOT_DIR"),
    "DATA_SEL": ("TRAIN", "TEST_DUMMY_DB", "TEST_QUERY_DB"),
    "MODEL": ("FS", "DUR", "HOP", "STFT_WIN", "STFT_HOP", "F_MIN", "F_MAX",
              "N_MELS", "EMB_SZ", "BN"),
    "BSZ": ("TR_BATCH_SZ", "TR_N_ANCHOR", "VAL_BATCH_SZ", "VAL_N_ANCHOR",
            "TS_BATCH_SZ"),
    "TRAIN": ("MAX_EPOCH", "OPTIMIZER", "LR", "LR_SCHEDULE"),
    "LOSS": ("LOSS_MODE", "TAU"),
    "TD_AUG": ("TR_SNR", "TR_BG_AUG", "TR_IR_AUG"),
    "SPEC_AUG": ("SPECAUG_CHAIN", "SPECAUG_PROBS", "SPECAUG_N_HOLES",
                 "SPECAUG_HOLE_FILL"),
    "DEVICE": (),
}

_CONFIG_SEARCH_DIRS = (
    "./config/",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "config/"),
)


def load_config(config_fname: str) -> Dict[str, Any]:
    """Load a YAML config by preset name or explicit path.

    Mirrors the reference CLI contract (``run.py:13-22``): a bare name looks
    for ``./config/<name>.yaml`` first, then falls back to the presets
    shipped inside the package.
    """
    candidates = []
    if config_fname.endswith((".yaml", ".yml")) or os.path.sep in config_fname:
        candidates.append(config_fname)
    for d in _CONFIG_SEARCH_DIRS:
        candidates.append(os.path.join(d, config_fname + ".yaml"))

    for path in candidates:
        if os.path.exists(path):
            with open(path, "r") as f:
                cfg = yaml.safe_load(f)
            validate_config(cfg, source=path)
            return cfg
    sys.exit(f"cli: ERROR! Configuration file for '{config_fname}' is missing "
             f"(searched: {candidates})")


def validate_config(cfg: Dict[str, Any], source: str = "<dict>") -> None:
    missing = []
    for section, keys in _REQUIRED.items():
        if section not in cfg:
            missing.append(section)
            continue
        for k in keys:
            if k not in cfg[section]:
                missing.append(f"{section}.{k}")
    if missing:
        raise KeyError(f"config {source} is missing required keys: {missing}")
    if cfg["BSZ"]["TR_BATCH_SZ"] % 2 != 0:
        raise ValueError("BSZ.TR_BATCH_SZ must be even "
                         "(anchors + replicas pairing)")


def update_config(cfg: Dict[str, Any], key1: str, key2: str, val) -> Dict[str, Any]:
    """CLI override by dict mutation (reference ``run.py:25-27``)."""
    cfg[key1][key2] = val
    return cfg


def print_config(cfg: Dict[str, Any]) -> None:
    print("\033[36m" +
          yaml.dump(cfg, indent=4, width=120, sort_keys=False) + "\033[0m")
