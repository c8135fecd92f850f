"""The port's convergence runner (``nafp_tpu_torch/extras/run_convergence.py``)
on the CPU: every stage (data, config, train, generate, evaluate) with
``--nogpu`` on a tiny corpus and tiny channels for one epoch, then a rerun
that skips every stage; the guard against a changed ``--epochs``; the
triplet recipe raises until it is ported."""
import glob
import json
import os

import numpy as np
import pytest
import yaml

from nafp_tpu_torch.extras import run_convergence as RC

SMALL_CH = [8, 8, 16, 16, 32, 32, 64, 64]
ARGS = ["--n_train", "4", "--n_query", "6", "--n_dummy", "3", "--sec", "4",
        "--epochs", "1", "--nogpu"]


def _shrink(cfg_path):
    """Tiny channels and batches, as the CPU tests train (the config stage
    derives the full-width 640_lamb preset)."""
    with open(cfg_path) as f:
        cfg = yaml.safe_load(f)
    cfg["MODEL"].update(EMB_SZ=16, FRONT_HIDDEN_CH=SMALL_CH,
                        MIXED_PRECISION=False)
    cfg["BSZ"].update(TR_BATCH_SZ=8, TR_N_ANCHOR=4, VAL_BATCH_SZ=8,
                      VAL_N_ANCHOR=4, TS_BATCH_SZ=8)
    cfg["TRAIN"]["TENSORBOARD"] = False
    cfg["DEVICE"]["SONG_CACHE_GB"] = 0
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    return cfg


def test_runner_all_stages_then_rerun_skips(tmp_path, capfd):
    root = str(tmp_path)
    RC.main(["--root", root, "--stages", "data,config"] + ARGS)
    cfg_path = os.path.join(root, "config", "conv640.yaml")
    with open(cfg_path) as f:
        derived = yaml.safe_load(f)
    assert derived["BSZ"]["TR_BATCH_SZ"] == 640            # 640_lamb
    assert derived["TRAIN"]["OPTIMIZER"] == "LAMB"
    assert derived["DEVICE"]["DEVICE_CORPUS"] is True
    assert derived["DEVICE"]["DEVICE_CORPUS_MAX_GB"] == 4
    assert derived["TRAIN"]["CHECKPOINT_INTERVAL"] == 10
    assert not derived["TRAIN"]["MINI_TEST_IN_TRAIN"]
    assert not derived["TRAIN"]["SAVE_IMG"]
    assert derived["DIR"]["SOURCE_ROOT_DIR"] == f"{root}/music/"
    assert len(glob.glob(f"{root}/music/test-dummy-db-100k-full/*.wav")) == 3
    assert not os.path.exists(f"{root}/_dummy")
    _shrink(cfg_path)
    capfd.readouterr()

    index = ["--index", "l2,ivf-sq8", "--test_ids", "5"]
    RC.main(["--root", root] + ARGS + index)
    out = capfd.readouterr().out
    assert "[data] exists" in out and "[config] exists" in out
    assert "train corpus: 4 songs resident" in out     # DEVICE_CORPUS on
    assert os.path.exists(f"{root}/logs/checkpoint/conv640/1/params.npz")
    assert json.load(open(f"{root}/generate.done.json"))["epoch"] == 1
    for key in ("dummy_db", "db", "query"):
        shape = np.load(f"{root}/logs/emb/conv640/1/{key}_shape.npy")
        assert shape[1] == 16
    for itype in ("l2", "ivf-sq8"):
        summary = json.load(open(f"{root}/eval_{itype}.json"))
        assert summary["index_type"] == itype and summary["n_test"] == 5
        assert np.load(f"{root}/raw_score_{itype}.npy").shape == (5, 24)
    runs = glob.glob(f"{root}/logs/fit/conv640/*")
    stamps = {p: os.path.getmtime(p) for p in glob.glob(f"{root}/eval_*")}

    RC.main(["--root", root] + ARGS + index)
    out = capfd.readouterr().out
    for line in ("[data] exists", "[config] exists",
                 "[train] checkpoint 1 exists", "[generate] epoch 1 exists",
                 "[evaluate] l2 exists", "[evaluate] ivf-sq8 exists"):
        assert line in out, out
    assert "+ " not in out                  # no subprocess ran
    assert glob.glob(f"{root}/logs/fit/conv640/*") == runs
    assert {p: os.path.getmtime(p) for p in stamps} == stamps


def test_changed_epochs_raise(tmp_path):
    root = str(tmp_path)
    RC.main(["--root", root, "--stages", "config", "--epochs", "3"])
    with pytest.raises(ValueError, match="MAX_EPOCH"):
        RC.main(["--root", root, "--stages", "config", "--epochs", "4"])


def test_triplet_recipe_raises(tmp_path):
    with pytest.raises(NotImplementedError, match="item 12"):
        RC.main(["--root", str(tmp_path), "--recipe", "now_playing"])
