"""Does training beat the untrained init at exact top-1, in the JAX package
and in the port alike? Both trainers, on the CPU, from the same initial
weights, on the same synthetic corpus, for the same epochs.

The JAX package's ``trainer`` and the port's ``trainer`` (``device="cpu"``)
run the ``default`` preset (bsz 120 = 60 anchors + 60 replicas, Adam,
cosine schedule over all epochs, layer_norm2d, background mix, IR,
SpecAugment) at a reduced width (``--div``: every channel and EMB_SZ
divided), f32 on both sides, on a corpus from
``extras/make_synth_dataset.py``. The port starts from the JAX package's
``init_params`` (seed 42) through ``flax_to_torch``, so both trainers start
from one set of weights; their draws follow the same law, not the same
stream.

Each model, untrained and trained, then fingerprints the corpus's held-out
query/db pairs and dummy songs (1 s segments, hop 0.5 s); exact top-1 at
1 s is the share of query segments whose nearest DB row (inner product
over db + dummy rows) is their own db segment. Printed as one JSON line
and written to ``OUT/result.json`` with both trainers' logged losses and
mini-search top-1.

Usage (CPU; about 20 min at the defaults on 8 cores):
    python tests/train_top1_jax_vs_port.py OUT [--epochs 3] [--div 4]
        [--n_train 120] [--sec 30] [--seed 0]
"""
import argparse
import glob
import json
import os
import subprocess
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax                                            # noqa: E402
import numpy as np                                    # noqa: E402
import torch                                          # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
N_QUERY, N_DUMMY = 20, 20


def make_cfg(root, epochs, div, seed):
    from nafp_tpu.configuration import load_config
    from nafp_tpu.models.nnfp import DEFAULT_CHANNELS
    cfg = load_config("default")
    ch = [c // div for c in DEFAULT_CHANNELS]
    cfg["MODEL"].update(FRONT_HIDDEN_CH=ch,
                        EMB_SZ=int(cfg["MODEL"]["EMB_SZ"]) // div,
                        MIXED_PRECISION=False)
    cfg["TRAIN"].update(MAX_EPOCH=epochs, TENSORBOARD=False,
                        MINI_TEST_IN_TRAIN=True, SAVE_IMG=False, SEED=seed)
    cfg["DEVICE"].update(MESH_DATA_PARALLEL=1, SONG_CACHE_GB=0)
    cfg["DATA_SEL"].update(TEST_QUERY_DB="unseen_icassp",
                           TEST_DUMMY_DB=str(N_DUMMY))
    cfg["DIR"].update(SOURCE_ROOT_DIR=f"{root}/music/",
                      BG_ROOT_DIR=f"{root}/aug/bg/",
                      IR_ROOT_DIR=f"{root}/aug/ir/",
                      SPEECH_ROOT_DIR=f"{root}/aug/speech/",
                      OUTPUT_ROOT_DIR=f"{root}/emb/",
                      LOG_ROOT_DIR=f"{root}/logs/")
    return cfg


def segments(cfg):
    """(query, db + dummy) waveforms of 1 s segments, and the db count."""
    from nafp_tpu.data.catalog import Dataset
    ds = Dataset(cfg)
    q_ds, db_ds = ds.get_test_query_db_ds()

    def stack(loader):
        out = []
        for i in range(len(loader)):
            b = loader[i]
            out.append(b["anchors"][:int(b["n_valid"])])
        return np.concatenate(out)
    q, db = stack(q_ds), stack(db_ds)
    return q, np.concatenate([db, stack(ds.get_test_dummy_db_ds())]), len(db)


def top1_at_1s(embed, q, db, n_db):
    eq, edb = embed(q), embed(db)
    hit = np.argmax(eq @ edb.T, axis=1) == np.arange(len(eq))
    assert len(eq) == n_db
    return 100.0 * float(hit.mean())


def jax_embedder(cfg, variables):
    from nafp_tpu.train.trainer import build_fp
    mel, _, model, _ = build_fp(cfg)
    f = jax.jit(lambda x: model.apply(variables, mel(x), train=False))
    return lambda x: np.concatenate([np.asarray(f(x[i:i + 120]))
                                     for i in range(0, len(x), 120)])


def port_embedder(cfg, state):
    from nafp_tpu_torch.train.trainer import build_fp
    mel, _, model, _ = build_fp(cfg)
    model.load_state_dict(state)
    model.eval()

    def f(x):
        with torch.no_grad():
            return np.concatenate([
                model(mel(torch.from_numpy(x[i:i + 120]))).numpy()
                for i in range(0, len(x), 120)])
    return f


def metrics(root, name):
    (path,) = glob.glob(f"{root}/logs/fit/{name}/*/metrics.jsonl")
    out = {}
    with open(path) as f:
        for line in f:
            m = json.loads(line)
            out.setdefault(m["tag"], {})[m["step"]] = m["value"]
    keep = ("loss/train", "loss/val", "mini_search/top1_g(f)_scope1")
    return {k: out[k] for k in keep if k in out}


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("out")
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--div", type=int, default=4)
    p.add_argument("--n_train", type=int, default=120)
    p.add_argument("--sec", type=int, default=30)
    p.add_argument("--seed", type=int, default=0,
                   help="TRAIN.SEED: both trainers' augmentation draws")
    a = p.parse_args()
    root = os.path.abspath(a.out)
    subprocess.run([sys.executable,
                    os.path.join(REPO, "extras", "make_synth_dataset.py"),
                    root, "--n_train", str(a.n_train), "--n_query",
                    str(N_QUERY), "--n_dummy", str(N_DUMMY), "--sec",
                    str(a.sec)], check=True, stdout=subprocess.DEVNULL)
    cfg = make_cfg(root, a.epochs, a.div, a.seed)

    from nafp_tpu.train import experiment as JEX
    from nafp_tpu.train import trainer as JTR
    from nafp_tpu_torch.models.convert import flax_to_torch
    from nafp_tpu_torch.train import trainer as PTR

    # the JAX package's initial weights (its trainer draws the same ones)
    _, _, jmodel, mcfg = JTR.build_fp(cfg)
    init = jax.tree_util.tree_map(np.asarray,
                                  JTR.init_params(cfg, jmodel, mcfg))
    # the JAX trainer's last saved params, captured as it saves them
    saved = {}
    jsave = JEX.ExperimentHelper.save

    def keep_params(self, epoch, state):
        saved[epoch] = jax.tree_util.tree_map(np.asarray, state["params"])
        return jsave(self, epoch, state)
    JEX.ExperimentHelper.save = keep_params
    t0 = time.perf_counter()
    JTR.trainer(cfg, "jax")
    jax_s = time.perf_counter() - t0

    # the port from the same weights
    pbuild = PTR.build_fp

    def build_from_init(c, seed=PTR.INIT_SEED):
        mel, spec, model, m = pbuild(c, seed)
        model.load_state_dict(flax_to_torch(init))
        return mel, spec, model, m
    PTR.build_fp = build_from_init
    t0 = time.perf_counter()
    PTR.trainer(cfg, "port", device="cpu")
    port_s = time.perf_counter() - t0
    PTR.build_fp = pbuild

    from nafp_tpu_torch.models.convert import find_params, load_params_npz
    path, _ = find_params(cfg, "port", None)
    q, db, n_db = segments(cfg)
    res = dict(
        epochs=a.epochs, div=a.div, n_train=a.n_train, sec=a.sec,
        seed=a.seed,
        channels=cfg["MODEL"]["FRONT_HIDDEN_CH"],
        emb_sz=cfg["MODEL"]["EMB_SZ"], n_query_segments=len(q),
        n_db_rows=len(db),
        top1_at_1s=dict(
            jax_init=top1_at_1s(jax_embedder(cfg, init), q, db, n_db),
            jax_trained=top1_at_1s(jax_embedder(cfg, saved[a.epochs]),
                                   q, db, n_db),
            port_init=top1_at_1s(port_embedder(cfg, flax_to_torch(init)),
                                 q, db, n_db),
            port_trained=top1_at_1s(port_embedder(
                cfg, flax_to_torch(load_params_npz(path))), q, db, n_db)),
        jax=metrics(root, "jax"), port=metrics(root, "port"),
        train_seconds=dict(jax=jax_s, port=port_s))
    with open(os.path.join(root, "result.json"), "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
