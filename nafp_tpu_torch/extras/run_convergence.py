#!/usr/bin/env python
"""Convergence-scale training drive of the port: the large-batch 640-LAMB
recipe on a synthetic corpus, trained to the end of its schedule and
scored on the ICASSP protocol.

Counterpart of ``extras/run_convergence.py``, with the same stages and
flags. ``--recipe now_playing`` trains the Online-Triplet loss, with
``--mining_mode`` and ``--margin`` overriding ``LOSS.MINING_MODE`` and
``LOSS.MARGIN``:

  data     — synthesize the corpus with the port's
             ``make_synth_dataset.py`` (numpy only, run as a
             subprocess): ``--n_train`` songs of
             ``--sec`` s, a quarter as many validation songs, ``--n_query``
             (500) query/db pairs and ``--n_dummy`` dummy-DB songs. The dummy songs do
             not depend on the rest, so a second subprocess writes them
             while the model trains (they are the same files one call
             would write); ``generate`` waits for it.
  config   — ROOT/config/NAME.yaml from the port's preset through its
             ``load_config``: paths under ROOT, ``DEVICE.DEVICE_CORPUS`` on
             (``DEVICE_CORPUS_MAX_GB`` 4), a checkpoint every 10 epochs,
             ``MINI_TEST_IN_TRAIN`` and ``SAVE_IMG`` off.
  train    — ``python -m nafp_tpu_torch.cli train NAME -c CONFIG``;
             ``--stop_epoch N`` stops it once checkpoint N is written,
             its schedule still MAX_EPOCH's (the JAX package's
             ``measurements/convtriphard_ep10_l2.json`` is epoch 10 of a
             100-epoch run).
  generate — fingerprints for {dummy_db, db, query} at the final epoch.
  evaluate — the sequence-level ICASSP protocol (hit rates x {1, 3, 5, 9,
             11, 19} segments) with the fixed test ids, once per index
             type of ``--index`` (a comma-separated list); each summary is
             copied to ROOT/eval_<TYPE>.json.
  init     — (not a default stage) the same protocol for the untrained
             model the run started from (seed 42) as checkpoint 0:
             generate, then ``evaluate -i l2`` into ROOT/eval_init_l2.json.

A stage whose artifact exists is skipped (data.done.json, the config
file, the final checkpoint, generate.done.json, eval_<TYPE>.json,
eval_init_l2.json), so a
rerun resumes where a run stopped. An existing config with another
``MAX_EPOCH`` raises: raising ``--epochs`` over a trained run would
rebuild its cosine schedule mid-run.

Usage (on the card; ``--nogpu`` runs every stage on the CPU):
    python -m nafp_tpu_torch.extras.run_convergence --root DIR
        [--n_train 1000] [--n_dummy 500] [--epochs 100]
        [--index l2,sq8,ivfpq,ivf-sq8]
        [--stages data,config,train,generate,evaluate]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import subprocess
import sys
import time
from typing import Optional

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SYNTH = os.path.join(REPO, "nafp_tpu_torch", "extras",
                     "make_synth_dataset.py")
NAMES = {"640_lamb": "conv640", "now_playing": "convtrip",
         "default": "convdef"}
INIT_INDEX = 0          # the checkpoint index of the untrained model


def write_init_checkpoint(cfg: dict, name: str) -> None:
    """LOG_ROOT_DIR/checkpoint/NAME/0/params.npz: the trainer's initial
    weights (``build_fp``'s seed 42) in the Flax layout."""
    from nafp_tpu_torch.models.convert import save_params_npz, torch_to_flax
    from nafp_tpu_torch.train.trainer import build_fp
    save_params_npz(os.path.join(cfg["DIR"]["LOG_ROOT_DIR"], "checkpoint",
                                 name, str(INIT_INDEX), "params.npz"),
                    torch_to_flax(build_fp(cfg)[2].state_dict()))


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def sh(args, root: str) -> float:
    print(f"+ {' '.join(args)}", flush=True)
    t0 = time.perf_counter()
    subprocess.run(args, cwd=root, env=_env(), check=True)
    secs = time.perf_counter() - t0
    print(f"  [{' '.join(args[3:5])}] {secs:.0f}s", flush=True)
    return secs


def train_until(args, root: str, marker: str, poll_s: float = 0.05) -> None:
    """Run the train command until ``marker`` (a checkpoint's meta.json,
    which appears with the whole checkpoint: the trainer renames it into
    place) exists, then stop it. The poll is far shorter than an epoch, so
    the next epoch's checkpoint is never reached."""
    print(f"+ {' '.join(args)} (until {marker})", flush=True)
    t0 = time.perf_counter()
    proc = subprocess.Popen(args, cwd=root, env=_env())
    try:
        while proc.poll() is None and not os.path.exists(marker):
            time.sleep(poll_s)
    finally:
        if proc.poll() is None:
            proc.terminate()
            proc.wait()
    if not os.path.exists(marker):
        raise RuntimeError(f"training exited ({proc.returncode}) before "
                           f"{marker}")
    print(f"  [train until {os.path.basename(os.path.dirname(marker))}] "
          f"{time.perf_counter() - t0:.0f}s", flush=True)


def _synth(root: str, n_train: int, n_query: int, n_dummy: int,
           sec: float) -> list:
    return [sys.executable, SYNTH, root, "--n_train", str(n_train),
            "--n_query", str(n_query), "--n_dummy", str(n_dummy),
            "--sec", str(sec)]


class DataStage:
    """The corpus: everything but the dummy DB in one subprocess, then the
    dummy DB in a second one that runs on in the background until
    :meth:`wait`."""

    def __init__(self, root: str, n_train: int, sec: float, n_dummy: int,
                 n_query: int = 500):
        self.root = root
        self.marker = os.path.join(root, "data.done.json")
        self.want = {"n_train": n_train, "n_query": n_query,
                     "n_dummy": n_dummy, "sec": sec}
        self.dummy_root = os.path.join(root, "_dummy")
        self.proc: Optional[subprocess.Popen] = None
        self.t0 = 0.0

    def done(self) -> bool:
        if not os.path.exists(self.marker):
            return False
        with open(self.marker) as f:
            return json.load(f) == self.want

    def start(self) -> None:
        if self.done():
            print("[data] exists", flush=True)
            return
        w = self.want
        self.t0 = time.perf_counter()
        for d in ("music", "aug", "_dummy"):
            shutil.rmtree(os.path.join(self.root, d), ignore_errors=True)
        subprocess.run(_synth(self.root, w["n_train"], w["n_query"], 0,
                              w["sec"]), check=True, stdout=subprocess.DEVNULL)
        print(f"[data] train, validation, query/db and augmentation songs "
              f"in {time.perf_counter() - self.t0:.0f}s; {w['n_dummy']} "
              f"dummy songs in the background", flush=True)
        self.proc = subprocess.Popen(
            _synth(self.dummy_root, 0, 0, w["n_dummy"], w["sec"]),
            stdout=subprocess.DEVNULL)

    def wait(self) -> None:
        if self.proc is None:
            return
        rc = self.proc.wait()
        self.proc = None
        if rc != 0:
            raise RuntimeError(f"dummy-DB synthesis failed (exit {rc})")
        sub = os.path.join("music", "test-dummy-db-100k-full")
        src = os.path.join(self.dummy_root, sub)
        if os.path.isdir(src):
            os.replace(src, os.path.join(self.root, sub))
        shutil.rmtree(self.dummy_root)
        with open(self.marker, "w") as f:
            json.dump(self.want, f)
        print(f"[data] complete in {time.perf_counter() - self.t0:.0f}s",
              flush=True)

    def stop(self) -> None:
        if self.proc is not None:
            self.proc.kill()
            self.proc.wait()
            self.proc = None


def stage_config(root: str, epochs: int, recipe: str, name: str,
                 margin: Optional[float] = None,
                 mining_mode: Optional[str] = None) -> str:
    import yaml
    from nafp_tpu_torch.configuration import load_config
    path = os.path.join(root, "config", f"{name}.yaml")
    if os.path.exists(path):
        with open(path) as f:
            have = yaml.safe_load(f)["TRAIN"]["MAX_EPOCH"]
        if have != epochs:
            raise ValueError(
                f"{path} trains {have} epochs, not --epochs {epochs}: a "
                "changed MAX_EPOCH rebuilds the cosine schedule of a run "
                "already under way; use another --root or --tag")
        print(f"[config] exists: {path}", flush=True)
        return path
    cfg = load_config(recipe)
    cfg["DIR"].update(
        SOURCE_ROOT_DIR=f"{root}/music/", BG_ROOT_DIR=f"{root}/aug/bg/",
        IR_ROOT_DIR=f"{root}/aug/ir/", SPEECH_ROOT_DIR=f"{root}/aug/speech/",
        OUTPUT_ROOT_DIR=f"{root}/logs/emb/", LOG_ROOT_DIR=f"{root}/logs/")
    cfg["TRAIN"].update(MAX_EPOCH=epochs, CHECKPOINT_INTERVAL=10,
                        MINI_TEST_IN_TRAIN=False, SAVE_IMG=False)
    cfg["DEVICE"].update(DEVICE_CORPUS=True, DEVICE_CORPUS_MAX_GB=4)
    if margin is not None:
        cfg["LOSS"]["MARGIN"] = float(margin)
    if mining_mode is not None:
        cfg["LOSS"]["MINING_MODE"] = mining_mode
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    print(f"[config] wrote {path}", flush=True)
    return path


def read_config(root: str, name: str) -> dict:
    import yaml
    with open(os.path.join(root, "config", f"{name}.yaml")) as f:
        return yaml.safe_load(f)


def newest_epoch(root: str, name: str) -> int:
    cands = [int(os.path.basename(p)) for p in
             glob.glob(os.path.join(root, f"logs/checkpoint/{name}/*"))
             if os.path.basename(p).isdigit()
             and os.path.basename(p) != str(INIT_INDEX)]
    if not cands:
        raise FileNotFoundError("no checkpoint found; run the train stage "
                                "first")
    return max(cands)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.join(REPO, "conv_run"),
                    help="working directory (corpus, config, logs)")
    ap.add_argument("--n_train", type=int, default=1000)
    ap.add_argument("--n_dummy", type=int, default=500,
                    help="dummy-DB songs; 10000 = the reference's "
                         "Dataset-mini scale (its config/default.yaml:19-31 "
                         "TEST_DUMMY_DB '10k_full')")
    ap.add_argument("--n_query", type=int, default=500,
                    help="query/db song pairs (500 as the reference's "
                         "test-query-db-500-30s)")
    ap.add_argument("--sec", type=float, default=30.0)
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--index", default="l2",
                    help="index type(s) to evaluate, comma-separated")
    ap.add_argument("--test_ids", default="icassp",
                    help="evaluate's -t: 'icassp' (the protocol's 2,000 "
                         "fixed ids), 'all' or a count")
    ap.add_argument("--recipe", default="640_lamb",
                    choices=("640_lamb", "now_playing", "default"),
                    help="config preset the run derives from")
    ap.add_argument("--margin", type=float, default=None,
                    help="override LOSS.MARGIN (triplet recipes only)")
    ap.add_argument("--mining_mode", default=None,
                    choices=("semi-hard", "hardest", "all", "all-balanced"),
                    help="override LOSS.MINING_MODE (triplet recipes only)")
    ap.add_argument("--tag", default="",
                    help="suffix for the run name so recipe variants keep "
                         "separate checkpoint/emb trees under one corpus")
    ap.add_argument("--stages",
                    default="data,config,train,generate,evaluate")
    ap.add_argument("--stop_epoch", type=int, default=None,
                    help="stop training once this epoch's checkpoint is "
                         "written (the schedule stays --epochs')")
    ap.add_argument("--nogpu", action="store_true",
                    help="run train, generate and evaluate on the CPU")
    ap.add_argument("--profile", action="store_true",
                    help="after each evaluate, run it again under "
                         "torch.profiler (extras/profile_evaluate.py) into "
                         "ROOT/profile_<TYPE>.json; needs the card")
    args = ap.parse_args(argv)
    if args.profile and args.nogpu:
        raise ValueError("--profile reads the card's trace: not with --nogpu")
    stages = set(args.stages.split(","))
    root = os.path.abspath(args.root)
    os.makedirs(root, exist_ok=True)
    name = NAMES[args.recipe] + args.tag
    cli = [sys.executable, "-m", "nafp_tpu_torch.cli"]
    gpu = ["--nogpu"] if args.nogpu else []
    cfg_path = os.path.join(root, "config", f"{name}.yaml")

    data = DataStage(root, args.n_train, args.sec, args.n_dummy,
                     args.n_query)
    try:
        if "data" in stages:
            data.start()
        if "config" in stages:
            stage_config(root, args.epochs, args.recipe, name,
                         margin=args.margin, mining_mode=args.mining_mode)
        if "train" in stages:
            final = args.stop_epoch or int(
                read_config(root, name)["TRAIN"]["MAX_EPOCH"])
            done = os.path.join(root, "logs", "checkpoint", name, str(final),
                                "meta.json")
            if os.path.exists(done):
                print(f"[train] checkpoint {final} exists", flush=True)
            elif args.stop_epoch:
                train_until(cli + ["train", name, "-c", cfg_path] + gpu,
                            root, done)
            else:
                sh(cli + ["train", name, "-c", cfg_path] + gpu, root)
        data.wait()
    finally:
        data.stop()
    ep = None
    if "generate" in stages:
        ep = newest_epoch(root, name)
        marker = os.path.join(root, "generate.done.json")
        if os.path.exists(marker) and json.load(open(marker))["epoch"] == ep:
            print(f"[generate] epoch {ep} exists", flush=True)
        else:
            secs = sh(cli + ["generate", name, str(ep), "-c", cfg_path, "-y"]
                      + gpu, root)
            with open(marker, "w") as f:
                json.dump({"epoch": ep, "seconds": secs}, f)
    if "evaluate" in stages:
        ep = ep or newest_epoch(root, name)
        emb_dir = os.path.join(read_config(root, name)["DIR"]
                               ["OUTPUT_ROOT_DIR"], name, str(ep))
        if not args.nogpu:
            # build the top-k kernels first, so no search time holds a build
            from nafp_tpu_torch import kernels
            print(f"[evaluate] kernels built in {kernels.build_all()[0]:.0f}s",
                  flush=True)
        for itype in args.index.split(","):
            out = os.path.join(root, f"eval_{itype}.json")
            if os.path.exists(out):
                print(f"[evaluate] {itype} exists: {out}", flush=True)
                continue
            cmd = ["evaluate", name, str(ep), "-c", cfg_path, "-i", itype,
                   "-t", args.test_ids]
            sh(cli + cmd + gpu, root)
            shutil.copy(os.path.join(emb_dir, "raw_score.npy"),
                        os.path.join(root, f"raw_score_{itype}.npy"))
            shutil.copy(os.path.join(emb_dir, "eval_summary.json"), out)
            if args.profile:
                sh([sys.executable, "-m",
                    "nafp_tpu_torch.extras.profile_evaluate",
                    os.path.join(root, f"profile_{itype}.json"), "--"] + cmd,
                   root)
    if "init" in stages:
        out = os.path.join(root, "eval_init_l2.json")
        if os.path.exists(out):
            print(f"[init] exists: {out}", flush=True)
        else:
            cfg = read_config(root, name)
            write_init_checkpoint(cfg, name)
            sh(cli + ["generate", name, str(INIT_INDEX), "-c", cfg_path, "-y"]
               + gpu, root)
            sh(cli + ["evaluate", name, str(INIT_INDEX), "-c", cfg_path, "-i",
                      "l2", "-t", args.test_ids] + gpu, root)
            emb_dir = os.path.join(cfg["DIR"]["OUTPUT_ROOT_DIR"], name,
                                   str(INIT_INDEX))
            shutil.copy(os.path.join(emb_dir, "raw_score.npy"),
                        os.path.join(root, "raw_score_init_l2.npy"))
            shutil.copy(os.path.join(emb_dir, "eval_summary.json"), out)


if __name__ == "__main__":
    main()
