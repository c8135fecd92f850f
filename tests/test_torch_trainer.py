"""Port parity: the training path (nafp_tpu_torch.train) against the JAX
package's on the CPU, at a tiny width (channels (8, 8, 16, 16, 32, 32, 64,
64), EMB_SZ 16, f32):

- one train step's loss and every gradient leaf against ``jax.value_and_
  grad`` of the JAX ``_make_loss_fn``, with background mix, IR and
  SpecAugment on and their draws injected, for layer_norm2d and batch_norm
  (running statistics after the step too);
- the training loop over two epochs of a tiny corpus, step by step from
  the same weights with each step's draws injected (Adam and LAMB,
  layer_norm2d and batch_norm), through a checkpoint and restore after
  epoch 1: batches, loss, parameters and running statistics;
- ``torch_to_flax``: the JAX model applied to a ``params.npz`` the port
  wrote gives the port's embeddings;
- ``cli train --nogpu`` for one epoch on a tiny corpus, a resume to epoch
  2, and ``generate --nogpu`` reading the port's checkpoint.
"""
import glob
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from click.testing import CliRunner

from nafp_tpu.configuration import load_config
from test_torch_augment import _jax_bg_draws, _jax_spec_draws

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_CH = [8, 8, 16, 16, 32, 32, 64, 64]
# f32 on both sides; XLA and PyTorch sum in other orders through 16
# convolutions, the norms and tau 0.05 (logits x20), and batch_norm's fast
# variance E[x²] − E[x]² cancels: the loss within 1e-4 relative (measured
# 1.2e-7 layer_norm2d, 2.8e-5 batch_norm), each gradient leaf within 1e-3
# relative in Frobenius norm (measured <= 2.2e-4), embeddings and running
# statistics within 2e-5.
LOSS_RTOL = 1e-4
GRAD_RTOL = 1e-3
EMB_ATOL = 2e-5
# The training loop over 8 steps at the default learning rate (1e-4): the
# loss relative to JAX's, and each leaf's distance from JAX's relative to
# how far JAX moved it from the initial weights. Adam's first updates are
# about lr·sign(g), so an element whose gradient is near 0 takes its sign
# from rounding. Measured worst: layer_norm2d + Adam loss 2.2e-6, leaves
# 1.8e-3; layer_norm2d + LAMB 1.4e-6, 7.2e-4; batch_norm + Adam loss
# 2.7e-4, running statistics 2.1e-4, leaves 0.21: the convolution biases
# in front of each BatchNorm have nearly cancelling gradients, which carry
# the fast variance's rounding (see above).
LOOP_STEPS = 4      # steps taken in each of the two epochs
LOOP_RTOL = {"layer_norm2d": {"loss": 1e-3, "params": 5e-3},
             "batch_norm": {"loss": 1e-3, "params": 0.3, "stats": 1e-3}}


def _cfg(norm="layer_norm2d", root=None):
    cfg = load_config("default")
    cfg["MODEL"].update(EMB_SZ=16, FRONT_HIDDEN_CH=SMALL_CH, BN=norm,
                        MIXED_PRECISION=False)
    cfg["BSZ"].update(TR_BATCH_SZ=8, TR_N_ANCHOR=4, VAL_BATCH_SZ=8,
                      VAL_N_ANCHOR=4, TS_BATCH_SZ=8)
    cfg["TRAIN"].update(MAX_EPOCH=1, TENSORBOARD=False, LR=3e-3)
    cfg["DEVICE"].update(MESH_DATA_PARALLEL=1, SONG_CACHE_GB=0)
    if root:
        cfg["DIR"].update(SOURCE_ROOT_DIR=f"{root}/music/",
                          BG_ROOT_DIR=f"{root}/aug/bg/",
                          IR_ROOT_DIR=f"{root}/aug/ir/",
                          OUTPUT_ROOT_DIR=f"{root}/emb/",
                          LOG_ROOT_DIR=f"{root}/logs/")
    return cfg


def _batch(seed, n=4, t=8000):
    rng = np.random.default_rng(seed)
    song = lambda: (0.4 * np.sin(np.arange(t)[None] * rng.uniform(
        0.01, 0.5, (n, 1))) + 0.1 * rng.standard_normal((n, t)))
    ir = rng.standard_normal((n, 600)) * np.exp(-np.arange(600) / 60.0)
    return {k: v.astype(np.float32) for k, v in
            dict(anchors=song(), replicas=song(), bg=song(), ir=ir).items()}


@pytest.mark.parametrize("norm", ["layer_norm2d", "batch_norm"])
def test_train_step_loss_and_grads_match_jax(norm):
    from nafp_tpu.train import trainer as JTR
    from nafp_tpu_torch.models.convert import flax_to_torch, torch_to_flax
    from nafp_tpu_torch.train import trainer as PTR

    cfg = _cfg(norm)
    melspec_fn, specaug_fn, model, _ = PTR.build_fp(cfg, seed=4)
    with torch.no_grad():        # every parameter and statistic matters
        rng = np.random.default_rng(1)
        for p in model.parameters():
            p.add_(torch.from_numpy(0.05 * rng.standard_normal(
                p.shape).astype(np.float32)))
    variables = torch_to_flax(model.state_dict())
    batch = _batch(2)
    key = jax.random.PRNGKey(9)
    k_td, k_spec = jax.random.split(key)
    sa = cfg["SPEC_AUG"]
    chain = tuple(sa["SPECAUG_CHAIN"])
    draws = {"td": _jax_bg_draws(k_td, 4, tuple(cfg["TD_AUG"]["TR_SNR"])),
             "spec": _jax_spec_draws(k_spec, chain, (1.0,) * len(chain),
                                     int(sa["SPECAUG_N_HOLES"]), True,
                                     (8, 256, 32, 1))}

    jmel, jspec, jmodel, _ = JTR.build_fp(cfg)
    jloss_fn = JTR._make_loss_fn(cfg, jmel, jspec, jmodel, train=True)
    stats = ({"batch_stats": variables["batch_stats"]}
             if "batch_stats" in variables else None)
    vg = jax.jit(jax.value_and_grad(
        lambda p, b, k, s: jloss_fn(p, b, k, None, s), has_aux=True))
    (jloss, (jsim, jstats)), jgrads = vg(
        {"params": variables["params"]},
        {k: jnp.asarray(v) for k, v in batch.items()}, key, stats)

    loss_fn = PTR._make_loss_fn(cfg, melspec_fn, specaug_fn, model,
                                train=True)
    model.train()
    loss, sim = loss_fn({k: torch.from_numpy(v) for k, v in batch.items()},
                        None, draws)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(sim.detach().numpy()[:, :4],
                               np.asarray(jsim)[:, :4], rtol=1e-4, atol=1e-3)
    got = flax_to_torch(torch_to_flax(
        {n: p.grad for n, p in model.named_parameters()}, norm))
    want = flax_to_torch(jax.tree_util.tree_map(np.asarray, jgrads))
    assert set(got) == set(want) and len(got) == 68
    for n in want:
        w, g = want[n].numpy(), got[n].numpy()
        err = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-12)
        assert err <= GRAD_RTOL, (n, err)
    if norm == "batch_norm":
        new = flax_to_torch({"params": {}, **jax.tree_util.tree_map(
            np.asarray, dict(jstats))})
        sd = model.state_dict()
        assert len(new) == 32
        for n, w in new.items():
            assert not np.allclose(w.numpy(), flax_to_torch(
                {"params": {}, "batch_stats": variables["batch_stats"]})[n])
            np.testing.assert_allclose(sd[n].numpy(), w.numpy(),
                                       atol=EMB_ATOL, rtol=1e-5, err_msg=n)


def _step_draws(cfg, key, n_rep, shape):
    """The draws the JAX train step takes from its step key: it folds in 0
    and splits into the time-domain and SpecAugment keys."""
    k_td, k_spec = jax.random.split(jax.random.fold_in(key, 0))
    sa = cfg["SPEC_AUG"]
    chain = tuple(sa["SPECAUG_CHAIN"])
    return {"td": _jax_bg_draws(k_td, n_rep, tuple(cfg["TD_AUG"]["TR_SNR"])),
            "spec": _jax_spec_draws(k_spec, chain, (1.0,) * len(chain),
                                    int(sa["SPECAUG_N_HOLES"]), True, shape)}


@pytest.mark.parametrize("norm,optimizer", [("layer_norm2d", "Adam"),
                                            ("batch_norm", "Adam"),
                                            ("layer_norm2d", "LAMB")])
def test_training_loop_tracks_jax_step_by_step(corpus, tmp_path, norm,
                                               optimizer):
    """The first LOOP_STEPS steps of two epochs of the tiny corpus (7 steps
    each) through both packages' train loaders and train steps, from the
    same weights, each step's draws taken from the JAX step's key and
    injected into the port: the loaders give the same batches (per-epoch
    shuffle and anchor offsets), and the loss, every parameter and every
    running statistic track JAX after every step, with the learning rate at
    the optimizer's count over a 2-epoch cosine. Between the epochs the
    port saves its checkpoint and goes on from a fresh model and optimizer
    restored from it, bit for bit."""
    from nafp_tpu.data.catalog import Dataset as JDataset
    from nafp_tpu.optim.schedules import build_optimizer as jbuild_optimizer
    from nafp_tpu.parallel.mesh import mesh_from_cfg
    from nafp_tpu.train import trainer as JTR
    from nafp_tpu_torch.data.catalog import Dataset
    from nafp_tpu_torch.models.convert import flax_to_torch, torch_to_flax
    from nafp_tpu_torch.optim.schedules import build_optimizer
    from nafp_tpu_torch.train import trainer as PTR
    from nafp_tpu_torch.train.experiment import ExperimentHelper

    root, _ = corpus
    cfg = _cfg(norm, root)
    cfg["TRAIN"].update(OPTIMIZER=optimizer, MAX_EPOCH=2,
                        LR=load_config("default")["TRAIN"]["LR"])
    cfg["DIR"]["LOG_ROOT_DIR"] = f"{tmp_path}/logs/"
    jds, ds = JDataset(cfg).get_train_ds(), Dataset(cfg).get_train_ds()
    total = 2 * len(ds)
    cpu = torch.device("cpu")
    mel, spec = PTR.build_fp(cfg)[:2]

    def port_state(restore):
        model = PTR.build_fp(cfg)[2]
        optim, sched = build_optimizer(cfg, model, total)
        step = ExperimentHelper("loop", cfg).restore_or_init(model, optim) \
            if restore else 0
        loss_fn = PTR._make_loss_fn(cfg, mel, spec, model, train=True,
                                    aug_keys=PTR._aug_keys(ds))
        return model, PTR.TrainStep(cfg, model, optim, sched, loss_fn, cpu,
                                    step)

    model, train_step = port_state(restore=False)
    jmel, jspec, jmodel, _ = JTR.build_fp(cfg)
    joptim = jbuild_optimizer(cfg, total)
    jvars = jax.tree_util.tree_map(jnp.asarray,
                                   torch_to_flax(model.state_dict(), norm))
    # committed to the device as the step's outputs are: one trace
    state = jax.device_put(JTR.TrainState(
        jvars, joptim.init({"params": jvars["params"]}),
        jnp.zeros([], jnp.int32)), jax.devices()[0])
    mesh = mesh_from_cfg(cfg)
    jstep = JTR.make_train_step(cfg, jmel, jspec, jmodel, joptim, mesh,
                                aug_keys=PTR._aug_keys(ds))
    upload = PTR.BatchUploader(cpu)
    base_key = jax.random.PRNGKey(int(cfg["TRAIN"].get("SEED", 0)))
    init = {n: t.clone() for n, t in model.state_dict().items()}
    for ep in (1, 2):
        if ep == 2:
            before = (model.state_dict(), train_step.optimizer.state_dict())
            ExperimentHelper("loop", cfg).save(1, model, train_step.optimizer,
                                               train_step.step)
            model, train_step = port_state(restore=True)
            assert train_step.step == LOOP_STEPS
            after = (model.state_dict(), train_step.optimizer.state_dict())
            for n, t in before[0].items():
                assert torch.equal(after[0][n], t), n
            assert before[1]["state"].keys() == after[1]["state"].keys()
            for i, st in before[1]["state"].items():
                for k, t in st.items():
                    a = after[1]["state"][i][k]
                    assert (torch.equal(a, t) if torch.is_tensor(t)
                            else a == t), (i, k)
        jds.set_epoch(ep)
        ds.set_epoch(ep)
        for i in range(LOOP_STEPS):
            jb, b = jds[i], ds[i]
            assert sorted(jb) == sorted(b)
            for k in b:
                np.testing.assert_array_equal(b[k], jb[k], err_msg=k)
            s = train_step.step
            key = jax.random.fold_in(base_key, s)
            state, jloss, _ = jstep(state, JTR._device_batch(jb, mesh), key)
            draws = _step_draws(cfg, key, len(b["replicas"]),
                                (len(b["anchors"]) + len(b["replicas"]),
                                 256, 32, 1))
            loss, _ = train_step(upload(b), draws)
            assert train_step.step == int(state.step) == s + 1
            errs = {"loss": abs(loss.item() / float(jloss) - 1)}
            want = flax_to_torch(jax.tree_util.tree_map(np.asarray,
                                                        state.params))
            got = model.state_dict()
            assert set(got) == set(want)
            for n, w in want.items():
                kind = "stats" if n.endswith(("_mean", "_var")) else "params"
                errs[kind] = max(errs.get(kind, 0.0), float(
                    (got[n] - w).norm() / max((w - init[n]).norm(), 1e-12)))
            for kind, e in errs.items():
                assert e <= LOOP_RTOL[norm][kind], (s, kind, e)


@pytest.mark.parametrize("norm", ["layer_norm2d", "layer_norm1d",
                                  "batch_norm"])
def test_port_checkpoint_runs_in_jax(tmp_path, norm):
    """torch_to_flax -> params.npz -> the JAX model: the port's
    embeddings."""
    from nafp_tpu.models.nnfp import get_fingerprinter
    from nafp_tpu_torch.models.convert import (load_params_npz,
                                               save_params_npz, torch_to_flax)
    from nafp_tpu_torch.models.nnfp import get_fingerprinter as tget

    cfg = _cfg(norm)
    model = tget(cfg, seed=3)
    with torch.no_grad():
        rng = np.random.default_rng(2)
        for t in model.state_dict().values():
            t.add_(torch.from_numpy(np.abs(0.1 * rng.standard_normal(
                t.shape)).astype(np.float32)))
    path = str(tmp_path / "params.npz")
    save_params_npz(path, torch_to_flax(model.state_dict()))
    x = np.random.default_rng(0).standard_normal(
        (3, 256, 32, 1)).astype(np.float32)
    want = np.asarray(get_fingerprinter(cfg).apply(load_params_npz(path),
                                                   jnp.asarray(x)))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=EMB_ATOL, rtol=0)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("train"))
    subprocess.run([sys.executable,
                    os.path.join(REPO, "extras", "make_synth_dataset.py"),
                    root, "--n_train", "4", "--n_query", "2", "--n_dummy",
                    "2", "--sec", "4"], check=True, stdout=subprocess.DEVNULL)
    cfg = _cfg(root=root)
    path = os.path.join(root, "tiny.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return root, path


def _metrics(root):
    runs = sorted(glob.glob(f"{root}/logs/fit/tiny/*/metrics.jsonl"))
    out = []
    for r in runs:
        with open(r) as f:
            out.append([json.loads(line) for line in f])
    return out


def test_cli_train_resume_generate(corpus):
    from nafp_tpu_torch.cli import main
    root, cfg_path = corpus
    res = CliRunner().invoke(main, ["train", "tiny", "-c", cfg_path,
                                    "--nogpu"])
    assert res.exit_code == 0, res.output + repr(res.exception)
    ck = f"{root}/logs/checkpoint/tiny"
    assert sorted(os.listdir(ck)) == ["1"]
    assert sorted(os.listdir(f"{ck}/1")) == ["meta.json", "params.npz",
                                             "train_state.pt"]
    (first,) = _metrics(root)
    tags = {m["tag"] for m in first}
    assert {"loss/train", "loss/val", "throughput/segments_per_sec",
            "mini_search/top1_g(f)_scope1"} <= tags
    assert all(np.isfinite(m["value"]) for m in first)
    with open(f"{ck}/1/meta.json") as f:
        steps = json.load(f)["step"]
    assert steps == 7            # 4 songs x 7 segments / 4 anchors

    res = CliRunner().invoke(main, ["train", "tiny", "-c", cfg_path,
                                    "--nogpu", "--max_epoch", "2"])
    assert res.exit_code == 0, res.output + repr(res.exception)
    assert "restored epoch 1" in res.output
    assert sorted(os.listdir(ck)) == ["1", "2"]
    second = _metrics(root)[1]
    assert {m["step"] for m in second} == {2}        # only epoch 2 trained
    with open(f"{ck}/2/meta.json") as f:
        assert json.load(f)["step"] == 2 * steps

    res = CliRunner().invoke(main, ["generate", "tiny", "-c", cfg_path,
                                    "--nogpu", "--yes"])
    assert res.exit_code == 0, res.output + repr(res.exception)
    from nafp_tpu_torch.data.audio_io import load_memmap
    emb, shape = load_memmap(f"{root}/emb/tiny/2", "query", display=False)
    assert shape == (14, 16) and np.isfinite(np.asarray(emb)).all()


@pytest.mark.parametrize("section,key,value,ported", [
    ("LOSS", "LOSS_MODE", "Online-Triplet", True),
    ("DEVICE", "DEVICE_CORPUS", True, True)],
    ids=["LOSS-LOSS_MODE-Online-Triplet", "DEVICE-DEVICE_CORPUS-True"])
def test_unported_training_options_raise(section, key, value, ported):
    """Both options are ported and accepted (the Online-Triplet loss and
    the device corpus); a loss the trainer does not know raises."""
    from nafp_tpu_torch.train.trainer import check_supported
    cfg = _cfg()
    check_supported(cfg)
    cfg[section][key] = value
    if ported:
        check_supported(cfg)
    cfg["LOSS"]["LOSS_MODE"] = "ArcFace"
    with pytest.raises(NotImplementedError, match="ArcFace"):
        check_supported(cfg)


def test_process_shard_round_robin(monkeypatch):
    import nafp_tpu_torch.parallel.mesh as M
    items = [f"s{i}" for i in range(7)]
    assert M.process_shard(items) == items            # no process group
    monkeypatch.setattr(M.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(M.dist, "get_world_size", lambda: 3)
    shards = []
    for rank in range(3):
        monkeypatch.setattr(M.dist, "get_rank", lambda r=rank: r)
        shards.append(M.process_shard(items))
    assert shards == [items[0::3], items[1::3], items[2::3]]


def test_trace_writes_a_chrome_trace(corpus, tmp_path):
    """``trace`` writes a Chrome trace; under ``TRAIN.PROFILE_DIR`` the
    trainer's first epoch is traced, the trace holds the port's spans of
    the train step's phases and of its loader, and the epoch's throughput
    is the step loop's plain totals: segments over the loop's seconds, and
    the loop's seconds a step."""
    from nafp_tpu_torch.train.trainer import trainer
    from nafp_tpu_torch.utils.profiling import trace
    with trace(str(tmp_path / "plain")):
        torch.ones(8).sum()
    (path,) = glob.glob(str(tmp_path / "plain" / "trace_*.json"))
    with open(path) as f:
        assert "traceEvents" in json.load(f)

    root, _ = corpus
    cfg = _cfg(root=root)
    cfg["DIR"]["LOG_ROOT_DIR"] = f"{tmp_path}/logs/"
    cfg["TRAIN"].update(PROFILE_DIR=str(tmp_path / "prof"),
                        MINI_TEST_IN_TRAIN=False)
    trainer(cfg, "traced", device="cpu")
    (path,) = glob.glob(str(tmp_path / "prof" / "trace_*.json"))
    with open(path) as f:
        names = [e.get("name") for e in json.load(f)["traceEvents"]]
    steps = names.count("train.optimizer")
    assert steps == 7                  # 4 songs x 7 segments / 4 anchors
    for phase in ("train.augment", "train.forward", "train.backward"):
        assert names.count(phase) == steps, phase
    assert names.count("loader.wait") >= steps
    (run,) = glob.glob(f"{tmp_path}/logs/fit/traced/*/metrics.jsonl")
    with open(run) as f:
        logged = {m["tag"]: m["value"] for m in map(json.loads, f)}
    rate = logged["throughput/segments_per_sec"]
    step_ms = logged["throughput/step_ms"]
    assert rate > 0 and step_ms > 0
    # one loop's totals: segments a step = rate x seconds a step
    assert rate * step_ms / 1e3 == pytest.approx(cfg["BSZ"]["TR_BATCH_SZ"])


def test_more_than_one_process_raises(monkeypatch):
    """Training in several processes is ported: under a 2-rank group the
    NT-Xent config passes ``check_supported``, and what raises is a global
    ``BSZ`` key the world size does not divide (each rank loads 1/world of
    the batch, the JAX package's rule)."""
    import nafp_tpu_torch.train.trainer as TR
    monkeypatch.setattr(TR.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(TR.dist, "get_world_size", lambda: 2)
    monkeypatch.setattr(TR.dist, "get_rank", lambda: 1)
    cfg = _cfg()
    TR.check_supported(cfg)
    assert TR.world() == (1, 2)
    split = TR.per_rank_batch(cfg, 2)
    assert [split["BSZ"][k] for k in TR.BSZ_SPLIT] == [4, 2, 4, 2]
    assert cfg["BSZ"]["TR_BATCH_SZ"] == 8          # the caller's dict kept
    cfg["BSZ"]["TR_N_ANCHOR"] = 3
    with pytest.raises(ValueError, match="TR_N_ANCHOR=3 not divisible by 2"):
        TR.per_rank_batch(cfg, 2)
