"""Port parity: the Online-Triplet training path (nafp_tpu_torch.losses.
triplet and the trainer's triplet branch) against the JAX package's, on
the CPU, at a tiny width (channels (8, 8, 16, 16, 32, 32, 64, 64), EMB_SZ
16, f32):

- ``online_triplet_loss`` in its four modes, with and without
  ``use_anc_as_pos``, at the cases of ``tests/test_losses.py`` (4 anchors
  x 2 replicas, margin 2.5; 8 x 4, margin 0.5) and at the now_playing
  layout (24 x 4, d 128), and with tied distances for 'hardest': loss,
  distances, ``num_active`` and the gradients of both inputs;
- one train step (loss and every gradient leaf) against ``jax.value_and_
  grad`` of the JAX ``_make_loss_fn`` with ``LOSS_MODE: Online-Triplet``,
  in training ('hardest' and 'semi-hard') and validation (mode 'all' at
  margin 0);
- the training loop, step by step, against the JAX ``make_train_step``;
- the JAX sharded step's gradient under ``pmean``, measured; two ``gloo``
  ranks against it.
``cli train`` of the now_playing preset runs in tests/test_torch_
convergence.py (``--recipe now_playing``).
"""
import functools
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from nafp_tpu.losses.triplet import online_triplet_loss as jax_triplet
from nafp_tpu_torch.losses.triplet import EPS, online_triplet_loss
from test_torch_augment import _jax_bg_draws, _jax_spec_draws
from test_torch_trainer import (GRAD_RTOL, LOOP_RTOL, LOSS_RTOL, _batch,
                                _cfg, _step_draws, corpus)  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ("semi-hard", "hardest", "all", "all-balanced")
# f32 products summed in another order (XLA's dot, PyTorch's matmul): the
# loss within 1e-5 relative, distances within 1e-6 (measured 7.6e-7 and
# 1.8e-7), the gradients within 1e-5 (measured 2.2e-8), num_active exact.
# The identity block of use_anc_as_pos (an anchor against itself) is
# sqrt(max(2(1 - a·a), 0) + EPS) of each package's own f32 a·a, which is
# 1 to within a few ulps whichever way it was summed: it lies between
# sqrt(EPS) and IDENTITY_MAX in both, and no loss, gradient or count
# reads it (it is neither a positive nor a negative).
LOSS_TRI_RTOL = 1e-5
DIST_ATOL = 1e-6
TRI_GRAD_ATOL = 1e-5
IDENTITY_MAX = float(np.sqrt(2 * 16 * 2.0 ** -24 + EPS))
LOSS_CASES = {"4x2_d16_m2.5": (4, 2, 16, 2.5), "8x4_d16_m0.5": (8, 4, 16, 0.5),
              "24x4_d128_m0.5": (24, 4, 128, 0.5)}
# The JAX sharded step differentiates each device's pmean of the per-device
# triplet losses and psums the gradients: measured 2.0000 times the global
# gradient on a 2-device mesh (every one of 68 leaves within 1.2e-5 of 2),
# as for NT-Xent (tests/test_torch_multiprocess.py::jax_grad_scale).
JAX_PMEAN_GRAD_FACTOR = 2.0
JAX_FACTOR_RTOL = 1e-4
SGD_LR = 1e-3
# parameters of magnitude <= ~1.5 after SGD moves of lr·g: a few f32 ulps
PARAM_ATOL = 1e-6
N_RANKS = 2
RANK_ANCHORS, RANK_PPA = 4, 2


def _unit_rows(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _both(ea, ep, n_anchor, n_ppa, margin, mode, uap):
    """(JAX's (loss, dists, num_active, grads), the port's)."""
    def f(a, p):
        loss, d, n = jax_triplet(a, p, n_anchor=n_anchor,
                                 n_pos_per_anchor=n_ppa, margin=margin,
                                 mode=mode, use_anc_as_pos=uap)
        return loss, (d, n)
    (jl, (jd, jn)), jg = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(ea), jnp.asarray(ep))
    ta = torch.from_numpy(ea).requires_grad_()
    tp = torch.from_numpy(ep).requires_grad_()
    loss, d, n = online_triplet_loss(ta, tp, n_anchor, n_ppa, margin, mode,
                                     uap)
    loss.backward()
    return ((float(jl), np.asarray(jd), float(jn),
             [np.asarray(g) for g in jg]),
            (loss.item(), d.detach().numpy(), n.item(),
             [ta.grad.numpy(), tp.grad.numpy()]))


def _check(want, got, n_anchor, n_pos, uap):
    (jl, jd, jn, jg), (pl, pd, pn, pg) = want, got
    np.testing.assert_allclose(pl, jl, rtol=LOSS_TRI_RTOL, atol=1e-7)
    assert pn == jn
    ident = np.zeros(jd.shape, bool)
    if uap:
        ident[:, n_pos:] = np.eye(n_anchor, dtype=bool)
        for d in (jd, pd):
            assert (d[ident] >= np.sqrt(EPS) - 1e-9).all()
            assert (d[ident] <= IDENTITY_MAX).all()
    np.testing.assert_allclose(pd[~ident], jd[~ident], atol=DIST_ATOL,
                               rtol=0)
    for g, w in zip(pg, jg):
        np.testing.assert_allclose(g, w, atol=TRI_GRAD_ATOL, rtol=0)


@pytest.mark.parametrize("uap", [True, False], ids=["anc_as_pos", "no_anc"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_triplet_loss_matches_jax(case, mode, uap):
    n_anchor, n_ppa, d, margin = LOSS_CASES[case]
    rng = np.random.default_rng(0)
    ea = _unit_rows(rng, n_anchor, d)
    ep = _unit_rows(rng, n_anchor * n_ppa, d)
    want, got = _both(ea, ep, n_anchor, n_ppa, margin, mode, uap)
    _check(want, got, n_anchor, n_anchor * n_ppa, uap)
    assert want[0] > 0 and any(np.abs(g).max() > 0 for g in want[3])


@pytest.mark.parametrize("uap", [True, False], ids=["anc_as_pos", "no_anc"])
def test_hardest_with_tied_distances_matches_jax(uap):
    """Replicas that coincide give tied positives (the max) and tied
    negatives (the min): JAX shares the gradient evenly among tied
    entries, and so must the port (``torch.max(dim)`` would send it all to
    one index)."""
    n_anchor, n_ppa, d = 4, 3, 16
    rng = np.random.default_rng(5)
    ea = _unit_rows(rng, n_anchor, d)
    ep = _unit_rows(rng, n_anchor * n_ppa, d)
    ep[1] = ep[0]                       # anchor 0's two farthest positives
    ep[2] = ep[0]
    ep[4] = ep[3] = ep[6]               # tied negatives of every other row
    want, got = _both(ea, ep, n_anchor, n_ppa, 1.5, "hardest", uap)
    _check(want, got, n_anchor, n_anchor * n_ppa, uap)
    g = got[3][1]
    np.testing.assert_allclose(g[1], g[0], atol=1e-7)    # shared evenly
    np.testing.assert_allclose(g[2], g[0], atol=1e-7)
    assert np.abs(g[0]).max() > 0


def test_unknown_mode_raises():
    x = torch.from_numpy(_unit_rows(np.random.default_rng(1), 2, 8))
    with pytest.raises(NotImplementedError, match="easy"):
        online_triplet_loss(x, x, 2, 1, mode="easy")


def _triplet_cfg(root=None, mode="hardest", bsz=12, n_anchor=4):
    cfg = _cfg("layer_norm2d", root)
    cfg["LOSS"].update(LOSS_MODE="Online-Triplet", MINING_MODE=mode,
                       MARGIN=0.5)
    cfg["BSZ"].update(TR_BATCH_SZ=bsz, TR_N_ANCHOR=n_anchor)
    return cfg


@pytest.mark.parametrize("mode,train", [("hardest", True),
                                        ("semi-hard", True),
                                        ("semi-hard", False)],
                         ids=["hardest", "semi-hard", "validation"])
def test_triplet_step_loss_and_grads_match_jax(mode, train):
    """One step of 4 anchors x 2 replicas with bg, IR and (in training)
    SpecAugment, their draws injected: the loss and all 68 gradient
    leaves against JAX's; validation mines with mode 'all' at margin 0
    whatever MINING_MODE says, and takes no SpecAugment."""
    from nafp_tpu.train import trainer as JTR
    from nafp_tpu_torch.models.convert import flax_to_torch, torch_to_flax
    from nafp_tpu_torch.train import trainer as PTR

    cfg = _triplet_cfg(mode=mode)
    melspec_fn, specaug_fn, model, _ = PTR.build_fp(cfg, seed=4)
    with torch.no_grad():
        rng = np.random.default_rng(1)
        for p in model.parameters():
            p.add_(torch.from_numpy(0.05 * rng.standard_normal(
                p.shape).astype(np.float32)))
    variables = torch_to_flax(model.state_dict())
    batch = _batch(2)
    batch["replicas"] = np.concatenate([batch["replicas"],
                                        _batch(3)["replicas"]])
    batch["bg"] = np.concatenate([batch["bg"], _batch(3)["bg"]])
    batch["ir"] = np.concatenate([batch["ir"], _batch(3)["ir"]])
    key = jax.random.PRNGKey(9)
    k_td, k_spec = jax.random.split(key)
    snr = tuple(cfg["TD_AUG"]["TR_SNR" if train else "VAL_SNR"])
    draws = {"td": _jax_bg_draws(k_td, 8, snr)}
    if train:
        sa = cfg["SPEC_AUG"]
        chain = tuple(sa["SPECAUG_CHAIN"])
        draws["spec"] = _jax_spec_draws(k_spec, chain, (1.0,) * len(chain),
                                        int(sa["SPECAUG_N_HOLES"]), True,
                                        (12, 256, 32, 1))
    jmel, jspec, jmodel, _ = JTR.build_fp(cfg)
    jloss_fn = JTR._make_loss_fn(cfg, jmel, jspec, jmodel, train=train)
    vg = jax.jit(jax.value_and_grad(
        lambda p, b, k: jloss_fn(p, b, k, None), has_aux=True))
    (jloss, (jsim, _)), jgrads = vg(
        {"params": variables["params"]},
        {k: jnp.asarray(v) for k, v in batch.items()}, key)

    loss_fn = PTR._make_loss_fn(cfg, melspec_fn, specaug_fn, model,
                                train=train)
    model.train(train)
    loss, sim = loss_fn({k: torch.from_numpy(v) for k, v in batch.items()},
                        None, draws)
    loss.backward()
    assert float(jloss) > 0
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    assert tuple(sim.shape) == (4, 12)                 # the distances
    np.testing.assert_allclose(sim.detach().numpy()[:, :8],
                               np.asarray(jsim)[:, :8], atol=1e-4)
    got = flax_to_torch(torch_to_flax(
        {n: p.grad for n, p in model.named_parameters()}))
    want = flax_to_torch(jax.tree_util.tree_map(np.asarray, jgrads))
    assert set(got) == set(want) and len(got) == 68
    for n in want:
        w, g = want[n].numpy(), got[n].numpy()
        err = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-12)
        assert err <= GRAD_RTOL, (n, err)


def _record_grads():
    """An optax transformation that passes the updates through and keeps
    the last ones in its state: the JAX step's gradient, read back."""
    import optax
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def test_triplet_training_loop_tracks_jax_step_by_step(corpus, tmp_path):
    """Three steps of the tiny corpus at 4 anchors x 2 replicas, 'hardest'
    mining, through both packages' loaders and train steps (the JAX
    ``make_train_step``, the port's ``TrainStep``) from the same weights,
    each step's draws taken from the JAX step's key: the same batches; at
    every step the loss within LOOP_RTOL (tests/test_torch_trainer.py) and
    each gradient leaf within GRAD_RTOL (its one-step tolerance), at the
    parameters the earlier steps left, and the parameters within
    PARAM_ATOL. Both sides take plain SGD: Adam's first updates are
    lr·sign(g), so an element whose gradient lies below the two packages'
    summation error flips sign (measured: one element of conv_layers.3.
    conv_1x3.weight with |g| 2e-7, 5 % of that leaf's move at step 0),
    and an SGD move far below a parameter's ulp is rounding; the gradient
    itself is what both compute. Adam and LAMB are held to optax in
    tests/test_torch_optim.py and in the NT-Xent loop of
    tests/test_torch_trainer.py."""
    import optax
    from nafp_tpu.data.catalog import Dataset as JDataset
    from nafp_tpu.parallel.mesh import mesh_from_cfg
    from nafp_tpu.train import trainer as JTR
    from nafp_tpu_torch.data.catalog import Dataset
    from nafp_tpu_torch.models.convert import flax_to_torch, torch_to_flax
    from nafp_tpu_torch.train import trainer as PTR

    root, _ = corpus
    cfg = _triplet_cfg(root)
    cfg["DIR"]["LOG_ROOT_DIR"] = f"{tmp_path}/logs/"
    jds, ds = JDataset(cfg).get_train_ds(), Dataset(cfg).get_train_ds()
    assert ds.n_pos_per_anchor == 2
    cpu = torch.device("cpu")
    mel, spec, model, _ = PTR.build_fp(cfg)
    optim = torch.optim.SGD(model.parameters(), lr=SGD_LR)
    train_step = PTR.TrainStep(
        cfg, model, optim, lambda s: SGD_LR, PTR._make_loss_fn(
            cfg, mel, spec, model, train=True, aug_keys=PTR._aug_keys(ds)),
        cpu)
    jmel, jspec, jmodel, _ = JTR.build_fp(cfg)
    joptim = optax.chain(_record_grads(), optax.sgd(SGD_LR))
    jvars = jax.tree_util.tree_map(jnp.asarray,
                                   torch_to_flax(model.state_dict()))
    state = jax.device_put(JTR.TrainState(
        jvars, joptim.init({"params": jvars["params"]}),
        jnp.zeros([], jnp.int32)), jax.devices()[0])
    mesh = mesh_from_cfg(cfg)
    jstep = JTR.make_train_step(cfg, jmel, jspec, jmodel, joptim, mesh,
                                aug_keys=PTR._aug_keys(ds))
    upload = PTR.BatchUploader(cpu)
    base_key = jax.random.PRNGKey(int(cfg["TRAIN"].get("SEED", 0)))
    jds.set_epoch(1)
    ds.set_epoch(1)
    for i in range(3):
        jb, b = jds[i], ds[i]
        for k in b:
            np.testing.assert_array_equal(b[k], jb[k], err_msg=k)
        s = train_step.step
        key = jax.random.fold_in(base_key, s)
        state, jloss, _ = jstep(state, JTR._device_batch(jb, mesh), key)
        draws = _step_draws(cfg, key, len(b["replicas"]),
                            (len(b["anchors"]) + len(b["replicas"]),
                             256, 32, 1))
        loss, _ = train_step(upload(b), draws)
        assert float(jloss) > 0
        assert abs(loss.item() / float(jloss) - 1) <= \
            LOOP_RTOL["layer_norm2d"]["loss"], s
        jgrads = flax_to_torch(jax.tree_util.tree_map(
            np.asarray, state.opt_state[0]))
        grads = flax_to_torch(torch_to_flax(
            {n: p.grad for n, p in model.named_parameters()}))
        assert len(jgrads) == 68
        for n, w in jgrads.items():
            err = float((grads[n] - w).norm() / max(w.norm(), 1e-12))
            assert err <= GRAD_RTOL, (s, n, err)
        want = flax_to_torch(jax.tree_util.tree_map(np.asarray,
                                                    state.params))
        got = model.state_dict()
        for n, w in want.items():
            np.testing.assert_allclose(got[n].numpy(), w.numpy(),
                                       atol=PARAM_ATOL, rtol=0,
                                       err_msg=f"step {s} {n}")


# -- several ranks -------------------------------------------------------
WORKER = r"""
import os, sys
sys.path.insert(0, os.environ["NAFP_REPO"])
import numpy as np
import torch
import yaml
torch.set_num_threads(2)
from nafp_tpu_torch.parallel.mesh import maybe_init_distributed, world
from nafp_tpu_torch.train import trainer as T
assert maybe_init_distributed(None, "cpu")
rank, size = world()
out, lr = sys.argv[1], float(sys.argv[2])
with open(os.path.join(out, "cfg.yaml")) as f:
    cfg = yaml.safe_load(f)
batch = dict(np.load(os.path.join(out, "batch.npz")))
share = {k: torch.from_numpy(np.split(v, size)[rank])
         for k, v in batch.items()}
# one SGD step from seeded weights on this rank's share
mel, spec, model, _ = T.build_fp(cfg, seed=4)
opt = torch.optim.SGD(model.parameters(), lr=lr)
step = T.TrainStep(cfg, model, opt, lambda s: lr,
                   T._make_loss_fn(cfg, mel, spec, model, train=True,
                                   aug_keys=frozenset()),
                   torch.device("cpu"))
res = {"loss0": step(share)[0].numpy()}
res.update({f"state/{n}": v.numpy() for n, v in model.state_dict().items()})
np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
torch.distributed.destroy_process_group()
"""


def rank_cfg():
    """The tiny triplet config at the global batch of N_RANKS ranks, each
    RANK_ANCHORS x RANK_PPA; augmentation off."""
    cfg = _triplet_cfg(bsz=N_RANKS * RANK_ANCHORS * (1 + RANK_PPA),
                       n_anchor=N_RANKS * RANK_ANCHORS)
    cfg["SPEC_AUG"]["SPECAUG_CHAIN"] = []
    return cfg


def _rank_batch(rng, n_ranks=N_RANKS):
    """Anchors, then their replicas anchor by anchor: rank r's share is
    the r-th slice of each."""
    t = np.arange(8000)[None]

    def song(n):
        return (0.4 * np.sin(t * rng.uniform(0.01, 0.5, (n, 1)))
                + 0.1 * rng.standard_normal((n, 8000))).astype(np.float32)
    return {"anchors": song(n_ranks * RANK_ANCHORS),
            "replicas": song(n_ranks * RANK_ANCHORS * RANK_PPA)}


@functools.lru_cache(maxsize=None)
def _jax_sharded_step():
    """The JAX sharded step of rank_cfg() on an N_RANKS-device mesh, with
    SGD's rate a hyperparameter of its state: compiled once for every
    rate this file steps at."""
    import optax
    from nafp_tpu.models import nnfp
    from nafp_tpu.ops.melspec import get_melspec_fn
    from nafp_tpu.ops.specaug import get_specaug_fn
    from nafp_tpu.parallel.mesh import make_data_mesh
    from nafp_tpu.train import trainer as JT
    cfg = rank_cfg()
    mel, _ = get_melspec_fn(cfg)
    model = nnfp.FingerPrinter(norm="layer_norm2d", dtype=jnp.float32,
                               emb_sz=16, front_hidden_ch=tuple(
                                   cfg["MODEL"]["FRONT_HIDDEN_CH"]))
    mesh = make_data_mesh(N_RANKS)
    opt = optax.inject_hyperparams(optax.sgd)(learning_rate=SGD_LR)
    step = JT.make_train_step(cfg, mel, get_specaug_fn(cfg), model, opt,
                              mesh, aug_keys=frozenset())
    return step, opt, mesh


def _jax_sharded(variables, batch, lr, steps):
    from nafp_tpu.train import trainer as JT
    from nafp_tpu_torch.models.convert import flax_to_torch
    step, opt, mesh = _jax_sharded_step()
    opt_state = opt.init({"params": variables["params"]})
    opt_state.hyperparams["learning_rate"] = jnp.asarray(lr, jnp.float32)
    state = JT.TrainState(variables, opt_state, jnp.zeros([], jnp.int32))
    db = JT._device_batch(batch, mesh)
    losses = []
    for i in range(steps):
        state, loss, _ = step(state, db, jax.random.PRNGKey(i))
        losses.append(float(loss))
    return losses, flax_to_torch(jax.tree_util.tree_map(
        np.asarray, dict(state.params)))


def _jax_variables(cfg):
    from nafp_tpu_torch.models.convert import torch_to_flax
    from nafp_tpu_torch.train import trainer as T
    return jax.tree_util.tree_map(jnp.asarray, torch_to_flax(
        T.build_fp(cfg, seed=4)[2].state_dict()))


def test_jax_sharded_triplet_gradient_factor():
    """Measures what the JAX sharded step's gradient is: on a batch whose
    two device shares are the same rows (so each device's log-mel max is
    the global one), one SGD step at rate 1 moves every leaf by
    JAX_PMEAN_GRAD_FACTOR times the gradient of one share's loss (= the
    pmean of the two)."""
    from nafp_tpu.models import nnfp
    from nafp_tpu.ops.melspec import get_melspec_fn
    from nafp_tpu.ops.specaug import get_specaug_fn
    from nafp_tpu.train import trainer as JT
    cfg = rank_cfg()
    half = _rank_batch(np.random.default_rng(3), n_ranks=1)
    batch = {k: np.concatenate([v] * N_RANKS) for k, v in half.items()}
    variables = _jax_variables(cfg)
    p0 = jax.tree_util.tree_map(np.asarray, variables["params"])
    mel, _ = get_melspec_fn(cfg)
    model = nnfp.FingerPrinter(norm="layer_norm2d", dtype=jnp.float32,
                               emb_sz=16, front_hidden_ch=tuple(
                                   cfg["MODEL"]["FRONT_HIDDEN_CH"]))
    loss_fn = JT._make_loss_fn(cfg, mel, get_specaug_fn(cfg), model,
                               train=True, aug_keys=frozenset())
    g = jax.jit(jax.grad(lambda p: loss_fn(
        p, {k: jnp.asarray(v) for k, v in half.items()},
        jax.random.PRNGKey(0), None)[0]))(
        {"params": variables["params"]})["params"]
    _, moved = _jax_sharded(variables, batch, 1.0, 1)
    from nafp_tpu_torch.models.convert import flax_to_torch
    before = flax_to_torch({"params": p0})
    grads = flax_to_torch({"params": jax.tree_util.tree_map(np.asarray, g)})
    assert len(grads) == 68
    for n, w in grads.items():
        step = (before[n] - moved[n]).numpy()
        np.testing.assert_allclose(
            np.linalg.norm(step) / np.linalg.norm(w.numpy()),
            JAX_PMEAN_GRAD_FACTOR, rtol=JAX_FACTOR_RTOL, err_msg=n)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("triplet_mp"))
    batch = _rank_batch(np.random.default_rng(11))
    np.savez(os.path.join(out, "batch.npz"), **batch)
    script = os.path.join(out, "worker.py")
    with open(script, "w") as f:
        f.write(WORKER)
    with open(os.path.join(out, "cfg.yaml"), "w") as f:
        yaml.safe_dump(rank_cfg(), f)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(N_RANKS):
        env = dict(os.environ, NAFP_REPO=REPO,
                   NAFP_COORDINATOR=f"localhost:{port}",
                   NAFP_NUM_PROCESSES=str(N_RANKS), NAFP_PROCESS_ID=str(rank),
                   OMP_NUM_THREADS="2")
        procs.append(subprocess.Popen(
            [sys.executable, script, out, str(SGD_LR)], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    cfg = rank_cfg()
    jax_ref = _jax_sharded(_jax_variables(cfg), batch,
                           SGD_LR / JAX_PMEAN_GRAD_FACTOR, 1)
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
    ranks = [dict(np.load(os.path.join(out, f"rank{r}.npz")))
             for r in range(N_RANKS)]
    return ranks, jax_ref


def test_two_ranks_equal_the_jax_sharded_triplet_step(two_ranks):
    """Each rank mines its own rows with no gather, and its loss is its
    share of the mean (JAX's pmean): the ranks agree bit for bit, and
    with one JAX sharded step at its measured factor the loss is within
    1e-4 relative and each parameter within 1e-3 of the size of its step
    (the tolerances of tests/test_torch_multiprocess.py)."""
    ranks, (losses, state) = two_ranks
    for key in ranks[0]:
        np.testing.assert_array_equal(ranks[0][key], ranks[1][key],
                                      err_msg=key)
    got = ranks[0]
    for i in range(len(losses)):
        assert losses[i] > 0
        np.testing.assert_allclose(got[f"loss{i}"], losses[i], rtol=1e-4)
    from nafp_tpu_torch.train import trainer as T
    init = {n: v.numpy() for n, v in T.build_fp(
        rank_cfg(), seed=4)[2].state_dict().items()}
    assert len(state) == 68
    for n, w in state.items():
        moved = np.linalg.norm(w.numpy() - init[n])
        err = np.linalg.norm(got[f"state/{n}"] - w.numpy())
        assert err <= 1e-3 * max(moved, 1e-12), (n, err, moved)
