"""Multi-process data-parallel training of nafp_tpu_torch, run for real: two
OS processes join a ``torch.distributed`` group on the ``gloo`` backend
(CPU), started through the ``NAFP_*`` variables as
``tests/test_multihost.py`` starts the JAX package's two processes.

Each rank takes its half of one global batch (tiny channel plan,
augmentation off) through two train steps (``TrainStep`` with plain SGD
at a constant rate, on both packages' side: an update is then the
gradient times the rate, so the parameters show the gradient, which
Adam's normalised first steps would hide), for ``layer_norm2d`` and
``batch_norm`` (cross-rank statistics), then runs ``trainer`` (Adam) for
one epoch of a tiny corpus. Checks:

- ``process_shard`` gives the ranks disjoint song lists that cover the
  list;
- the ranks' losses are equal, and their gradients, parameters and
  running statistics bit-identical;
- the two ranks equal the single-process port step on the concatenated
  global batch: every parameter and running statistic after the two
  steps within 1e-5 absolute; the loss and each gradient leaf (relative,
  Frobenius) within 1e-5 for ``layer_norm2d`` (measured 1.2e-7 and
  4.5e-6), and within 1e-4 and 1e-3 for ``batch_norm``, whose statistics
  are averages of the ranks' half-batch sums (measured 1.6e-5 and 1.5e-4:
  the fast variance E[x²] − E[x]² cancels);
- they equal the JAX sharded step on the 8-device CPU mesh from the same
  weights (``models/convert.py``), whose gradient is the mesh size times
  the global one (``jax_grad_scale``): the loss within 1e-4 relative, each
  parameter leaf within 1e-3 of the size of its two steps and each
  statistic within 1e-3 of its move (the train-step tolerances of
  tests/test_torch_trainer.py; measured 2.7e-5, 1.6e-4, 1.1e-5);
- ``trainer`` in two processes: only rank 0 writes the checkpoint and
  metrics, both ranks save the same parameters, and a ``BSZ`` key the
  world size does not divide raises.
"""
import glob
import os
import socket
import subprocess
import sys
import wave

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_CH = [8, 8, 16, 16, 32, 32, 64, 64]
NORMS = ("layer_norm2d", "batch_norm")
N_GLOBAL = 8                 # anchors (and replicas) in the global batch
WEIGHT_SEED = 4
SGD_LR = 1e-3
SINGLE_LOSS_RTOL = {"layer_norm2d": 1e-5, "batch_norm": 1e-4}
SINGLE_GRAD_RTOL = {"layer_norm2d": 1e-5, "batch_norm": 1e-3}
SINGLE_ATOL = 1e-5
JAX_LOSS_RTOL = 1e-4         # port vs JAX (tests/test_torch_trainer.py)
JAX_MOVE_RTOL = 1e-3

WORKER = r"""
import os, sys
sys.path.insert(0, os.environ["NAFP_REPO"])
import numpy as np
import torch
torch.set_num_threads(2)
from nafp_tpu_torch.parallel.mesh import (maybe_init_distributed,
                                          process_shard, world)
assert maybe_init_distributed(None, "cpu"), "NAFP_* must start the group"
assert maybe_init_distributed(None, "cpu"), "a second call is a no-op"
rank, size = world()
assert size == 2 and torch.distributed.get_backend() == "gloo"
print("SHARD", ",".join(process_shard([f"song{i}" for i in range(9)])),
      flush=True)

sys.path.insert(0, os.path.join(os.environ["NAFP_REPO"], "tests"))
from test_torch_multiprocess import port_steps, port_cfg
out, corpus = sys.argv[1], sys.argv[2]
batch = dict(np.load(os.path.join(out, "batch.npz")))
half = batch["anchors"].shape[0] // size
local = {k: v[rank * half:(rank + 1) * half] for k, v in batch.items()}
for norm in ("layer_norm2d", "batch_norm"):
    np.savez(os.path.join(out, f"{norm}_rank{rank}.npz"),
             **port_steps(norm, local))

from nafp_tpu_torch.train import experiment as E, trainer as T
save = E.ExperimentHelper.save
def save_and_report(self, epoch, model, optimizer, step):
    cksum = sum(float(v.double().abs().sum())
                for v in model.state_dict().values())
    print(f"SAVED {epoch} {step} {cksum!r}", flush=True)
    return save(self, epoch, model, optimizer, step)
E.ExperimentHelper.save = save_and_report
cfg = port_cfg("layer_norm2d", corpus)
T.trainer(cfg, "mp", device="cpu")
cfg["BSZ"]["TR_N_ANCHOR"] = 3
try:
    T.trainer(cfg, "mp_bad", device="cpu")
except ValueError as e:
    print("BSZ_RAISES", e, flush=True)
torch.distributed.destroy_process_group()
"""


def _write_wav(path, x, fs=8000):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with wave.open(path, "w") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(fs)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype(np.int16).tobytes())


def _song(seed, sec, fs=8000):
    r = np.random.default_rng(seed)
    t = np.arange(int(fs * sec)) / fs
    x = sum(r.uniform(0.2, 0.5) * np.sin(2 * np.pi * r.uniform(100, 3500) * t)
            for _ in range(3))
    return 0.8 * x / np.abs(x).max()


def port_cfg(norm, root=None):
    """The tiny config, global batch 16 (8 anchors); augmentation off."""
    from nafp_tpu_torch.configuration import load_config as port_load
    cfg = port_load("default")
    cfg["MODEL"].update(EMB_SZ=16, FRONT_HIDDEN_CH=SMALL_CH, BN=norm,
                        MIXED_PRECISION=False)
    cfg["BSZ"].update(TR_BATCH_SZ=2 * N_GLOBAL, TR_N_ANCHOR=N_GLOBAL,
                      VAL_BATCH_SZ=2 * N_GLOBAL, VAL_N_ANCHOR=N_GLOBAL)
    cfg["SPEC_AUG"]["SPECAUG_CHAIN"] = []
    cfg["TRAIN"].update(MAX_EPOCH=1, TENSORBOARD=False, SAVE_IMG=False,
                        MINI_TEST_IN_TRAIN=True)
    cfg["DEVICE"]["SONG_CACHE_GB"] = 0
    if root:
        cfg["DIR"].update(SOURCE_ROOT_DIR=f"{root}/music/",
                          LOG_ROOT_DIR=f"{root}/logs/")
    return cfg


def port_steps(norm, batch, steps=2):
    """Two port train steps (SGD at SGD_LR) from the seeded weights on
    ``batch`` (this rank's share under a process group): the losses, the
    gradients of step 1 and the state after the last step."""
    from nafp_tpu_torch.train import trainer as T
    cfg = port_cfg(norm)
    mel, spec, model, _ = T.build_fp(cfg, seed=WEIGHT_SEED)
    opt = torch.optim.SGD(model.parameters(), lr=SGD_LR)
    step = T.TrainStep(cfg, model, opt, lambda s: SGD_LR,
                       T._make_loss_fn(cfg, mel, spec, model, train=True,
                                       aug_keys=frozenset()),
                       torch.device("cpu"))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = {}
    for i in range(steps):
        loss, _ = step(tb)
        out[f"loss{i}"] = loss.numpy()
        if i == 0:
            out.update({f"grad/{n}": p.grad.numpy().copy()
                        for n, p in model.named_parameters()})
    out.update({f"state/{n}": v.numpy()
                for n, v in model.state_dict().items()})
    return out


def jax_grad_scale(mesh_size):
    """The JAX package's sharded step (``nafp_tpu/train/trainer.py``
    ``make_train_step``) differentiates each device's copy of the GLOBAL
    loss (NT-Xent's ``psum`` of ``loss_sum``, the ``all_gather`` transposed
    into a sum over devices) and then ``psum``s the gradients: its gradient
    is the global batch's times the mesh size (measured 8.0000 on the
    8-device mesh, every leaf). Adam and LAMB normalise it away; SGD would
    not. The port's sum of the ranks' shares is the global gradient (one
    process's on the same batch), so the JAX side runs SGD at the rate
    divided by this."""
    return mesh_size


def _global_batch():
    rng = np.random.default_rng(11)
    t = np.arange(8000)[None]
    song = lambda: (0.4 * np.sin(t * rng.uniform(0.01, 0.5, (N_GLOBAL, 1)))
                    + 0.1 * rng.standard_normal((N_GLOBAL, 8000)))
    return {"anchors": song().astype(np.float32),
            "replicas": song().astype(np.float32)}


def _jax_sharded_steps(norm, batch, steps=2):
    """The JAX package's sharded train step (SGD at SGD_LR) on the
    8-device mesh, from the port's seeded weights: the losses and the
    variables after the steps, in the port's names."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from nafp_tpu.configuration import load_config
    from nafp_tpu.models import nnfp
    from nafp_tpu.ops.melspec import get_melspec_fn
    from nafp_tpu.ops.specaug import get_specaug_fn
    from nafp_tpu.parallel.mesh import make_data_mesh
    from nafp_tpu.train import trainer as JT
    from nafp_tpu_torch.models.convert import flax_to_torch, torch_to_flax
    from nafp_tpu_torch.train import trainer as T

    model_t = T.build_fp(port_cfg(norm), seed=WEIGHT_SEED)[2]
    variables = jax.tree_util.tree_map(
        jnp.asarray, torch_to_flax(model_t.state_dict(), norm))
    cfg = load_config("default")
    cfg["MODEL"].update(BN=norm)
    cfg["BSZ"].update(TR_BATCH_SZ=2 * N_GLOBAL, TR_N_ANCHOR=N_GLOBAL)
    cfg["SPEC_AUG"]["SPECAUG_CHAIN"] = []
    mel, _ = get_melspec_fn(cfg)
    model = nnfp.FingerPrinter(norm=norm, dtype=jnp.float32, bn_axis="data",
                               emb_sz=16, front_hidden_ch=tuple(SMALL_CH))
    mesh = make_data_mesh(8)
    opt = optax.sgd(SGD_LR / jax_grad_scale(mesh.size))
    state = JT.TrainState(variables, opt.init({"params": variables["params"]}),
                          jnp.zeros([], jnp.int32))
    state = jax.device_put(state, NamedSharding(mesh, P()))
    step = JT.make_train_step(cfg, mel, get_specaug_fn(cfg), model, opt, mesh,
                              aug_keys=frozenset())
    db = JT._device_batch(batch, mesh)
    losses = []
    for i in range(steps):
        state, loss, _ = step(state, db, jax.random.PRNGKey(i))
        losses.append(float(loss))
    return losses, flax_to_torch(jax.tree_util.tree_map(np.asarray,
                                                        dict(state.params)))


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Both ranks' outputs: step results per norm, and the trainer run."""
    out = str(tmp_path_factory.mktemp("mp"))
    corpus = os.path.join(out, "corpus")
    for i in range(4):
        _write_wav(f"{corpus}/music/train-10k-30s/{i}.wav", _song(40 + i, 3.0))
        _write_wav(f"{corpus}/music/val-query-db-500-30s/{i}.wav",
                   _song(60 + i, 3.0))
    batch = _global_batch()
    np.savez(os.path.join(out, "batch.npz"), **batch)
    script = os.path.join(out, "worker.py")
    with open(script, "w") as f:
        f.write(WORKER)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(2):
        env = dict(os.environ, NAFP_REPO=REPO,
                   NAFP_COORDINATOR=f"localhost:{port}",
                   NAFP_NUM_PROCESSES="2", NAFP_PROCESS_ID=str(rank),
                   OMP_NUM_THREADS="2")
        procs.append(subprocess.Popen(
            [sys.executable, script, out, corpus], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    # the references, while the ranks run
    single = {n: port_steps(n, batch) for n in NORMS}
    jax_ref = {n: _jax_sharded_steps(n, batch) for n in NORMS}
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=600)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{log}"
    ranks = {n: [dict(np.load(os.path.join(out, f"{n}_rank{r}.npz")))
                 for r in range(2)] for n in NORMS}
    return dict(logs=logs, ranks=ranks, single=single, jax=jax_ref,
                corpus=corpus, batch=batch)


def _grab(log, tag):
    return [ln.split(" ", 1)[1] for ln in log.splitlines()
            if ln.startswith(tag + " ")]


def test_song_shards_disjoint_and_cover(two_ranks):
    s0, s1 = (_grab(log, "SHARD")[0].split(",") for log in two_ranks["logs"])
    assert s0 == [f"song{i}" for i in range(0, 9, 2)]
    assert s1 == [f"song{i}" for i in range(1, 9, 2)]


@pytest.mark.parametrize("norm", NORMS)
def test_ranks_agree_bit_for_bit(two_ranks, norm):
    r0, r1 = two_ranks["ranks"][norm]
    assert set(r0) == set(r1)
    for key in r0:
        np.testing.assert_array_equal(r0[key], r1[key], err_msg=key)
    assert np.isfinite([r0["loss0"], r0["loss1"]]).all()


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def _init_state(norm):
    from nafp_tpu_torch.train import trainer as T
    return {n: v.numpy() for n, v in T.build_fp(
        port_cfg(norm), seed=WEIGHT_SEED)[2].state_dict().items()}


def _move_errors(got, want, init):
    """Worst distance from ``want`` by kind: a parameter's relative to the
    size of its two SGD steps (2·rate·|step-1 gradient|, which a sum of
    two gradients that nearly cancel does not shrink), a running
    statistic's relative to its move away from ``init``."""
    errs = {}
    for n, w in want.items():
        d = np.linalg.norm(got[f"state/{n}"] - w)
        if n.endswith(("_mean", "_var")):
            kind, scale = "stats", np.linalg.norm(w - init[n])
        else:
            kind = "params"
            scale = 2 * SGD_LR * np.linalg.norm(got[f"grad/{n}"])
        errs[kind] = max(errs.get(kind, 0.0), float(d / max(scale, 1e-12)))
    return errs


@pytest.mark.parametrize("norm", NORMS)
def test_two_ranks_equal_one_process_on_the_global_batch(two_ranks, norm):
    """The gradient is the global batch's: a rank that averaged instead of
    summing would be off by a factor 2 here."""
    got, want = two_ranks["ranks"][norm][0], two_ranks["single"][norm]
    for i in range(2):
        np.testing.assert_allclose(got[f"loss{i}"], want[f"loss{i}"],
                                   rtol=SINGLE_LOSS_RTOL[norm])
    grads = [k for k in want if k.startswith("grad/")]
    assert len(grads) == 68
    for k in grads:
        err = _rel(got[k], want[k])
        assert err <= SINGLE_GRAD_RTOL[norm], (k, err)
    state = [k for k in want if k.startswith("state/")]
    assert len(state) == (100 if norm == "batch_norm" else 68)
    for k in state:
        np.testing.assert_allclose(got[k], want[k], atol=SINGLE_ATOL, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("norm", NORMS)
def test_two_ranks_equal_the_jax_sharded_step(two_ranks, norm):
    got = two_ranks["ranks"][norm][0]
    losses, state = two_ranks["jax"][norm]
    for i in range(2):
        np.testing.assert_allclose(got[f"loss{i}"], losses[i],
                                   rtol=JAX_LOSS_RTOL)
    assert len(state) == len([k for k in got if k.startswith("state/")])
    init = _init_state(norm)
    errs = _move_errors(got, {n: w.numpy() for n, w in state.items()}, init)
    assert max(errs.values()) <= JAX_MOVE_RTOL, errs
    if norm == "batch_norm":        # the statistics moved off their init
        name = "state/conv_layers.0.norm_1.running_var"
        assert np.abs(got[name] - init[name[6:]]).max() > 1e-6


def test_trainer_in_two_processes(two_ranks):
    """One epoch of ``trainer`` on two ranks: both save the same weights at
    the same step, rank 0 alone writes the checkpoint and metrics, the
    in-training mini-search is skipped as in the JAX package, and a BSZ
    key that 2 does not divide raises on both ranks."""
    saved = [_grab(log, "SAVED") for log in two_ranks["logs"]]
    assert len(saved[0]) == 1 and saved[0] == saved[1]
    logs = two_ranks["logs"]
    assert "MINI_TEST_IN_TRAIN skipped" in logs[0]
    for log in logs:
        assert "TR_N_ANCHOR=3 not divisible by 2" in _grab(log,
                                                           "BSZ_RAISES")[0]
    root = two_ranks["corpus"]
    assert os.path.exists(f"{root}/logs/checkpoint/mp/1/params.npz")
    runs = glob.glob(f"{root}/logs/fit/mp/*/metrics.jsonl")
    assert len(runs) == 1
    with open(runs[0]) as f:
        body = f.read()
    assert "loss/train" in body and "loss/val" in body
