"""The port's convergence runner (``nafp_tpu_torch/extras/run_convergence.py``)
on the CPU: every stage (data, config, train, generate, evaluate) with
``--nogpu`` on a tiny corpus and tiny channels for one epoch, then a rerun
that skips every stage; the guard against a changed ``--epochs``; the
triplet recipe (``--recipe now_playing``) with its mining mode and
margin."""
import glob
import json
import os

import numpy as np
import pytest
import torch
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

@pytest.fixture
def one_thread(monkeypatch):
    """torch on one thread for the test (and OMP_NUM_THREADS 1 for the
    processes it starts): many small ops on a CPU shared by several test
    workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    yield
    torch.set_num_threads(threads)


def test_triplet_recipe_raises(tmp_path, one_thread):
    """``--recipe now_playing`` is ported: its config is the now_playing
    preset (Online-Triplet, bsz 120 with 24 anchors) with ``--mining_mode``
    and ``--margin`` applied, and it trains (tiny width, 4 anchors x 2
    replicas, on the device corpus); ``--stop_epoch 1`` of a 2-epoch
    schedule stops after checkpoint 1. An unknown mining mode still raises,
    at the command line."""
    root = str(tmp_path)
    with pytest.raises(SystemExit):
        RC.main(["--root", root, "--recipe", "now_playing",
                 "--mining_mode", "easy"])
    tri = ["--recipe", "now_playing", "--mining_mode", "hardest",
           "--margin", "0.3", "--epochs", "2"]
    RC.main(["--root", root, "--stages", "data,config"] + ARGS + tri)
    cfg_path = os.path.join(root, "config", "convtrip.yaml")
    with open(cfg_path) as f:
        derived = yaml.safe_load(f)
    assert derived["LOSS"] == {**derived["LOSS"],
                               "LOSS_MODE": "Online-Triplet",
                               "MINING_MODE": "hardest", "MARGIN": 0.3}
    assert (derived["BSZ"]["TR_BATCH_SZ"], derived["BSZ"]["TR_N_ANCHOR"]) \
        == (120, 24)
    cfg = _shrink(cfg_path)
    cfg["BSZ"].update(TR_BATCH_SZ=12, TR_N_ANCHOR=4)
    cfg["TRAIN"]["CHECKPOINT_INTERVAL"] = 1
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    RC.main(["--root", root, "--stages", "train", "--stop_epoch", "1"]
            + ARGS + tri)
    ck = f"{root}/logs/checkpoint/convtrip"
    assert os.path.exists(f"{ck}/1/params.npz")
    assert not os.path.exists(f"{ck}/2")
    (run,) = glob.glob(f"{root}/logs/fit/convtrip/*/metrics.jsonl")
    with open(run) as f:
        m = {(r["tag"], r["step"]): r["value"] for r in map(json.loads, f)}
    assert np.isfinite([m["loss/train", 1], m["loss/val", 1]]).all()
