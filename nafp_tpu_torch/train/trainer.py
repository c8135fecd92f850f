"""Training workload: the epoch loop, on one device or one per process.

Counterpart of ``nafp_tpu/train/trainer.py`` (reference
``model/trainer.py:19-230``). One train step is: time-domain augmentation
of the replicas (ops/tdaug.py) -> log-mel of anchors and replicas
together (the subtract-max runs over the whole batch, as in the JAX
package) -> SpecAugment (training only) -> encoder forward/backward ->
the loss of ``emb[:n_anchor]`` against ``emb[n_anchor:]`` (``LOSS.
LOSS_MODE``: NT-Xent, or the online triplet loss, mined with ``LOSS.
MINING_MODE`` at ``LOSS.MARGIN`` in training and with mode 'all' at
margin 0 in validation, as the JAX package) -> optimizer update, with
the learning rate the schedule gives at the optimizer's pre-increment
step. BatchNorm running statistics are updated by the
model's forward pass in training mode, not by the optimizer.

The host loader only reads waveforms; each batch goes up through reused
pinned buffers with ``non_blocking=True`` (no host allocation per step).
Losses stay on the device and are read once per epoch (and once per 50
steps for the progress line).

Random draws: the train step draws from a generator on the run's device
seeded by (TRAIN.SEED, step); validation step i of epoch ep by (TRAIN.SEED,
1_000_000 + ep·10_000 + i); the mini-search augmentation of batch i by i.
These are the JAX package's keys: the same law, not the same draws. Rank
r > 0 of a process group mixes r into each seed (the JAX package folds in
the device's axis index); rank 0 draws what a single process draws. The
initial weights come from seed 42, as the JAX package's ``init_params``.

Several processes (``torch.distributed``, one per card; ``nccl`` on CUDA,
``gloo`` on the CPU; joined by ``parallel.mesh.maybe_init_distributed``
from ``NAFP_*`` or ``DEVICE.MULTIHOST``): the ``BSZ`` keys are the global
batch and each rank loads its 1/world share from its round-robin share of
the songs. The log-mel subtract-max is the global batch's, NT-Xent
gathers every rank's embeddings (its backward sums over the ranks),
BatchNorm averages its statistics over the ranks, and the gradients are
summed over the ranks (each rank's loss is its share of the global loss,
so a sum, not DDP's average, is the global gradient; the triplet loss is
mined on each rank's own rows with no gather, and its share is the
rank's loss over the world size, the JAX package's ``pmean``): every
rank ends a step with the same parameters. The step counts per epoch are the minimum
over ranks. Only rank 0 writes checkpoints and metrics; the others wait
at a barrier behind each save.

``DEVICE.DEVICE_CORPUS``: the training songs are resident on the card
and each batch is gathered there (``data/device_corpus.py``); validation
keeps the host loader, as in the JAX package.
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from nafp_tpu_torch.data.catalog import Dataset
from nafp_tpu_torch.data.device_corpus import maybe_device_loader
from nafp_tpu_torch.data.loader import SegmentLoader, prefetch
from nafp_tpu_torch.device import DeviceLike, resolve_device
from nafp_tpu_torch.losses.ntxent import ntxent_loss
from nafp_tpu_torch.losses.triplet import online_triplet_loss
from nafp_tpu_torch.models.nnfp import FingerPrinter, get_fingerprinter
from nafp_tpu_torch.ops.melspec import get_melspec_fn
from nafp_tpu_torch.ops.specaug import get_specaug_fn
from nafp_tpu_torch.ops.tdaug import augment_replicas
from nafp_tpu_torch.optim.schedules import Schedule, build_optimizer
from nafp_tpu_torch.parallel.mesh import (all_gather, all_reduce_,
                                          maybe_init_distributed, rank_device,
                                          world)
from nafp_tpu_torch.search.minisearch import mini_search_eval
from nafp_tpu_torch.train.experiment import ExperimentHelper
from nafp_tpu_torch.utils.profiling import span, trace

INIT_SEED = 42       # the JAX package's init_params key
BATCH_KEYS = ("anchors", "replicas", "bg", "ir", "speech")
# pinned buffer sets of BatchUploader: one is filled while the other's
# copies may still be in flight
UPLOAD_SLOTS = 2
LOSS_MODES = ("NTXENT", "ONLINE-TRIPLET")


def check_supported(cfg: Dict[str, Any]) -> None:
    """Raise for a loss the trainer does not know."""
    if str(cfg["LOSS"]["LOSS_MODE"]).upper() not in LOSS_MODES:
        raise NotImplementedError(
            f"LOSS.LOSS_MODE {cfg['LOSS']['LOSS_MODE']!r}: 'NTxent' or "
            "'Online-Triplet'")


BSZ_SPLIT = ("TR_BATCH_SZ", "TR_N_ANCHOR", "VAL_BATCH_SZ", "VAL_N_ANCHOR")


def per_rank_batch(cfg: Dict[str, Any], size: int) -> Dict[str, Any]:
    """``cfg`` with the global ``BSZ`` keys divided by the world size (a
    new dict; ``cfg`` itself for one process). A key the world size does
    not divide raises."""
    if size <= 1:
        return cfg
    b = dict(cfg["BSZ"])
    for k in BSZ_SPLIT:
        if int(b[k]) % size:
            raise ValueError(f"BSZ.{k}={b[k]} not divisible by {size} "
                             "processes")
        b[k] = int(b[k]) // size
    return {**cfg, "BSZ": b}


def step_seed(seed: int, step: int, rank: int = 0) -> int:
    """One 64-bit generator seed from (seed, step), and the rank when it
    is not 0."""
    entropy = [seed, step] + ([rank] if rank else [])
    return int(np.random.SeedSequence(entropy).generate_state(
        1, np.uint64)[0])


def min_over_ranks(n: int, device: torch.device) -> int:
    """The smallest ``n`` of the ranks (``n`` for one process): every rank
    must enter the same number of collectives, or a straggler deadlocks."""
    if world()[1] <= 1:
        return n
    t = torch.tensor([n], dtype=torch.int64, device=device)
    return int(all_reduce_(t, "min").item())


def all_reduce_grads(params) -> None:
    """Sum every gradient over the ranks, in one flat buffer."""
    grads = [p.grad for p in params if p.grad is not None]
    if world()[1] <= 1 or not grads:
        return
    flat = all_reduce_(torch.cat([g.reshape(-1) for g in grads]))
    for g, v in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(v.view_as(g))


def build_fp(cfg: Dict[str, Any], seed: int = INIT_SEED):
    """melspec fn, specaug fn, FingerPrinter (initial weights from
    ``seed``, on the CPU), MelSpecConfig (reference build_fp)."""
    melspec_fn, mcfg = get_melspec_fn(cfg)
    return melspec_fn, get_specaug_fn(cfg), get_fingerprinter(cfg, seed), mcfg


def _make_loss_fn(cfg, melspec_fn, specaug_fn, model: FingerPrinter,
                  train: bool, aug_keys: Optional[frozenset] = None):
    """``loss_fn(batch, gen, draws=None) -> (loss, sim)`` on device
    tensors; ``sim`` is NT-Xent's logits or the triplet loss's distances.
    ``aug_keys`` names the augmentation sources the loader really has
    (default: the batch's keys). ``draws`` replaces the generator's
    draws: ``{"td": {"snr": (n, 1), "amp": (n, 1)}, "spec": [one dict per
    SpecAugment layer]}``. The model's mode (train/eval) is the caller's.
    Under a process group of more than one rank the batch is this rank's
    share, and the loss is its share of the global loss."""
    check_supported(cfg)
    triplet = str(cfg["LOSS"]["LOSS_MODE"]).upper() == "ONLINE-TRIPLET"
    tau = float(cfg["LOSS"]["TAU"])
    # the reference pins 'semi-hard' in training (model/trainer.py:159-163);
    # LOSS.MINING_MODE exposes the loss's other reductions, as in JAX
    margin = float(cfg["LOSS"]["MARGIN"]) if train else 0.0
    mining = (str(cfg["LOSS"].get("MINING_MODE", "semi-hard")) if train
              else "all")
    td = cfg["TD_AUG"]
    pre = "TR" if train else "VAL"
    snr = tuple(td[f"{pre}_SNR"])
    use_bg, use_ir = bool(td[f"{pre}_BG_AUG"]), bool(td[f"{pre}_IR_AUG"])
    use_speech = bool(td.get(f"{pre}_SPEECH_AUG", False))

    def loss_fn(batch: Dict[str, torch.Tensor], gen: torch.Generator,
                draws: Optional[Dict[str, Any]] = None):
        have = aug_keys if aug_keys is not None else frozenset(
            k for k in ("bg", "ir", "speech") if k in batch)
        draws = draws or {}
        xa = batch["anchors"]
        on_card = xa.is_cuda
        rank, size = world()
        with span("train.augment", device=on_card):
            xp = augment_replicas(batch["replicas"], batch.get("bg"),
                                  batch.get("ir"), gen, snr,
                                  use_bg=use_bg and "bg" in have,
                                  use_ir=use_ir and "ir" in have,
                                  speech=batch.get("speech"),
                                  use_speech=use_speech and "speech" in have,
                                  **draws.get("td", {}))
            feat = melspec_fn(torch.cat([xa, xp], dim=0),
                              across_ranks=size > 1)
            if train:
                feat = specaug_fn(feat, gen, draws=draws.get("spec"))
        with span("train.forward", device=on_card):
            emb = model(feat)
            n = xa.shape[0]
            ea, ep = emb[:n], emb[n:]
            if triplet:
                loss, dists, _ = online_triplet_loss(
                    ea, ep, n_anchor=n, n_pos_per_anchor=(len(emb) - n) // n,
                    margin=margin, mode=mining)
                return loss / size, dists
            # one process: all_gather is the identity and the offset 0
            return ntxent_loss(ea, ep, tau=tau,
                               gathered=(all_gather(ea), all_gather(ep)),
                               offset=rank * n)

    return loss_fn


class TrainStep:
    """One optimizer step per call on a device batch; ``step`` is the
    optimizer's count (the number of updates made). Under a process group
    the gradients are summed over the ranks before the update, and the
    returned loss is the global loss (the sum of the ranks' shares)."""

    def __init__(self, cfg: Dict[str, Any], model: FingerPrinter,
                 optimizer: torch.optim.Optimizer, schedule: Schedule,
                 loss_fn: Callable, device: torch.device, step: int = 0):
        self.model, self.optimizer, self.schedule = model, optimizer, schedule
        self.loss_fn = loss_fn
        self.seed = int(cfg["TRAIN"].get("SEED", 0))
        self.gen = torch.Generator(device=device)
        self.step = int(step)

    def __call__(self, batch: Dict[str, torch.Tensor],
                 draws: Optional[Dict[str, Any]] = None):
        self.model.train()
        rank, _ = world()
        self.gen.manual_seed(step_seed(self.seed, self.step, rank))
        for g in self.optimizer.param_groups:
            g["lr"] = self.schedule(self.step)
        loss, sim = self.loss_fn(batch, self.gen, draws)
        with span("train.backward", device=loss.is_cuda):
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            all_reduce_grads(self.model.parameters())
        with span("train.optimizer", device=loss.is_cuda):
            self.optimizer.step()
        self.step += 1
        loss = loss.detach()
        if world()[1] > 1:
            loss = all_reduce_(loss.clone())
        return loss, sim.detach()


class BatchUploader:
    """Host batches (dicts of numpy arrays) -> device tensors.

    On the card each key has a pinned host buffer in each of UPLOAD_SLOTS
    slots, reused every step; a slot is refilled only after the event
    recorded behind its last copy has passed, so a copy in flight is never
    overwritten. A batch that is already on the device (the device corpus)
    passes through untouched."""

    def __init__(self, device: torch.device):
        self.device = device
        self.pinned = device.type == "cuda"
        self._slots = [dict() for _ in range(UPLOAD_SLOTS)]
        self._events = ([torch.cuda.Event() for _ in range(UPLOAD_SLOTS)]
                        if self.pinned else [])
        self._used = [False] * UPLOAD_SLOTS
        self._i = 0

    def __call__(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        keys = [k for k in BATCH_KEYS if k in batch]
        if all(torch.is_tensor(batch[k]) for k in keys):
            return {k: batch[k] for k in keys}
        if not self.pinned:
            return {k: torch.from_numpy(np.asarray(batch[k], np.float32)).to(
                self.device) for k in keys}
        i = self._i
        self._i = (i + 1) % len(self._slots)
        if self._used[i]:
            self._events[i].synchronize()
        slot, out = self._slots[i], {}
        for k in keys:
            a = batch[k]
            buf = slot.get(k)
            if buf is None or tuple(buf.shape) != a.shape:
                buf = slot[k] = torch.empty(a.shape, dtype=torch.float32,
                                            pin_memory=True)
            buf.numpy()[...] = a
            out[k] = buf.to(self.device, non_blocking=True)
        self._events[i].record()
        self._used[i] = True
        return out


def _aug_keys(ds: SegmentLoader) -> frozenset:
    return frozenset(k for k, on in (("bg", ds.bg_mix), ("ir", ds.ir_mix),
                                     ("speech", ds.speech_mix)) if on)


def mini_search_validation(ds: SegmentLoader, model: FingerPrinter,
                           melspec_fn, device: torch.device,
                           aug_fn: Optional[Callable] = None,
                           scopes=(1, 3, 5, 9, 11, 19),
                           max_n_samples: int = 3000,
                           display: bool = True):
    """A mini DB (anchors) and query set (replicas, degraded by
    ``aug_fn(replicas, bg, ir, gen, speech=None)`` when given) from
    validation batches, searched at the taps f / L2(f) / g(f) (reference
    trainer.py:80-108); batch i's augmentation draws from a generator
    seeded by i."""
    keys = ("f", "L2(f)", "g(f)")
    n_iter = max(1, min(len(ds), max_n_samples // ds.bsz))
    db = {k: [] for k in keys}
    query = {k: [] for k in keys}
    upload = BatchUploader(device)
    model.eval()
    with torch.no_grad():
        for i in range(n_iter):
            b = upload(ds[i])
            xp = b["replicas"]
            if aug_fn is not None:
                gen = torch.Generator(device=device).manual_seed(i)
                xp = aug_fn(xp, b.get("bg"), b.get("ir"), gen,
                            speech=b.get("speech"))
            n_anchor = b["anchors"].shape[0]
            taps = model.taps(melspec_fn(torch.cat([b["anchors"], xp])))
            for k, e in zip(keys, taps):
                db[k].append(e[:n_anchor])
                query[k].append(e[n_anchor:])
    accs_by_scope = {}
    for k in keys:
        if display:
            print(f"== mini-search-validation [{k}] ==")
        accs_by_scope[k], _ = mini_search_eval(
            torch.cat(query[k])[:, None, :], torch.cat(db[k]),
            scopes=list(scopes), mode="argmin", display=display)
    return accs_by_scope, list(scopes), list(keys)


def trainer(cfg: Dict[str, Any], checkpoint_name: str,
            device: DeviceLike = None) -> None:
    """The epoch loop (reference trainer.py:111-230). ``device`` defaults
    to ``cuda:0`` (raises when no card is present); in a process group of
    several ranks on CUDA, rank r runs on ``cuda:{LOCAL_RANK}``."""
    device = resolve_device(device)
    check_supported(cfg)
    maybe_init_distributed(cfg, device)
    device = rank_device(device)
    rank, size = world()
    lead = rank == 0
    cfg = per_rank_batch(cfg, size)
    dataset = Dataset(cfg)
    melspec_fn, specaug_fn, model, _ = build_fp(cfg)
    model.to(device)
    print(f"[trainer] on {device}"
          + (f" (rank {rank} of {size})" if size > 1 else "")
          + f": {sum(p.numel() for p in model.parameters())}"
          f" parameters, MODEL.BN {model.norm}, {model.dtype}")

    train_ds = maybe_device_loader(
        dataset.get_train_ds(cfg["DATA_SEL"]["REDUCE_ITEMS_P"]), cfg,
        label="train corpus", device=device)
    steps_per_epoch = min_over_ranks(len(train_ds), device)
    ep_max = int(cfg["TRAIN"]["MAX_EPOCH"])
    optimizer, schedule = build_optimizer(cfg, model,
                                          ep_max * steps_per_epoch)
    helper = ExperimentHelper(checkpoint_name, cfg, lead=lead)
    if size > 1:
        dist.barrier()    # no rank reads a checkpoint rank 0 still writes
    step = helper.restore_or_init(model, optimizer)
    val_ds = dataset.get_val_ds(max_song=250)
    val_steps = min_over_ranks(len(val_ds), device)

    train_step = TrainStep(
        cfg, model, optimizer, schedule,
        _make_loss_fn(cfg, melspec_fn, specaug_fn, model, train=True,
                      aug_keys=_aug_keys(train_ds)), device, step)
    val_loss_fn = _make_loss_fn(cfg, melspec_fn, specaug_fn, model,
                                train=False, aug_keys=_aug_keys(val_ds))
    td = cfg["TD_AUG"]
    val_aug = dict(snr_range=tuple(td["VAL_SNR"]),
                   use_bg=bool(td["VAL_BG_AUG"]),
                   use_ir=bool(td["VAL_IR_AUG"]),
                   use_speech=bool(td.get("VAL_SPEECH_AUG", False)))

    def mini_aug(xp, bg, ir, gen, speech=None):
        if bg is None and ir is None and speech is None:
            return xp
        return augment_replicas(xp, bg, ir, gen, speech=speech, **val_aug)

    upload = BatchUploader(device)
    val_gen = torch.Generator(device=device)
    seed = train_step.seed
    # the similarity images are this rank's rows only: one process only,
    # as in the JAX package
    save_img = (bool(cfg["TRAIN"].get("SAVE_IMG")) and helper.has_images
                and size == 1)
    profile_dir = cfg["TRAIN"].get("PROFILE_DIR")
    ckpt_every = int(cfg["TRAIN"].get("CHECKPOINT_INTERVAL", 1) or 1)

    for ep in range(helper.epoch, ep_max + 1):
        if lead:
            print(f"EPOCH: {ep}/{ep_max}")
        t_ep = time.perf_counter()
        train_ds.set_epoch(ep)
        losses, sim = [], None
        with (trace(profile_dir) if profile_dir and ep == helper.epoch
              and lead else contextlib.nullcontext()):
            t_loop = time.perf_counter()
            for i, batch in enumerate(prefetch(train_ds)):
                if i >= steps_per_epoch:
                    break
                loss, sim = train_step(upload(batch))
                losses.append(loss)
                if i % 50 == 0 and lead:
                    mean_ms = 1e3 * (time.perf_counter() - t_loop) / (i + 1)
                    print(f"  step {i}/{steps_per_epoch} tr_loss "
                          f"{float(loss):.4f} step {mean_ms:.0f} ms",
                          end="\r")
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            loop_s = time.perf_counter() - t_loop
        tr_loss = (float(torch.stack(losses).mean()) if losses
                   else float("nan"))
        helper.log_scalar("loss/train", tr_loss, ep)
        if losses:
            # the epoch's step loop as a whole, ended by a synchronise
            helper.log_scalar("throughput/segments_per_sec",
                              len(losses) * train_ds.bsz * size / loop_s, ep)
            helper.log_scalar("throughput/step_ms",
                              1e3 * loop_s / len(losses), ep)
        if save_img and sim is not None:
            helper.log_sim_images("tr_sim_mtx", sim.cpu().numpy(), ep)

        # validation: no SpecAugment, TD augmentation per VAL_* flags
        val_losses = []
        model.eval()
        with torch.no_grad():
            for i, batch in enumerate(prefetch(val_ds)):
                if i >= val_steps:
                    break
                val_gen.manual_seed(step_seed(
                    seed, 1_000_000 + ep * 10_000 + i, rank))
                loss, sim = val_loss_fn(upload(batch), val_gen)
                val_losses.append(all_reduce_(loss) if size > 1 else loss)
        val_loss = (float(torch.stack(val_losses).mean()) if val_losses
                    else float("nan"))
        helper.log_scalar("loss/val", val_loss, ep)
        helper.log_scalar("time/epoch_sec", time.perf_counter() - t_ep, ep)
        if save_img and val_losses:
            helper.log_sim_images("val_sim_mtx", sim.cpu().numpy(), ep)
        if lead:
            print(f"tr_loss:{tr_loss:.4f}, val_loss:{val_loss:.4f}")

        if ep % ckpt_every == 0 or ep == ep_max:
            helper.save(ep, model, optimizer, train_step.step)
            if size > 1:
                dist.barrier()

        if cfg["TRAIN"].get("MINI_TEST_IN_TRAIN") and size > 1:
            if lead:
                print("[trainer] MINI_TEST_IN_TRAIN skipped with several "
                      "processes, as in the JAX package (run evaluate on a "
                      "checkpoint instead)")
        elif cfg["TRAIN"].get("MINI_TEST_IN_TRAIN"):
            accs_by_scope, scopes, key_strs = mini_search_validation(
                val_ds, model, melspec_fn, device, aug_fn=mini_aug)
            for k in key_strs:
                helper.update_minitest_acc(accs_by_scope[k], scopes, k, ep)
    helper.close()
