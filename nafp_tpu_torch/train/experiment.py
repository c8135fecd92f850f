"""Experiment infrastructure: checkpoints, resume, metric logging.

Counterpart of ``nafp_tpu/train/experiment.py`` (reference
``model/utils/experiment_helper.py:10-237``), without orbax:
  - one checkpoint per saved epoch, so checkpoint index == epoch, under
    ``LOG_ROOT_DIR/checkpoint/NAME/<epoch>/``: ``params.npz`` (the model's
    variables in the Flax layout, batch_stats included: what ``generate``
    of either package reads), ``train_state.pt`` (the optimizer's state)
    and ``meta.json`` (epoch, optimizer step, save time; written last, so
    a directory without it is incomplete and ignored). The random draws
    are functions of (TRAIN.SEED, step), so the step restores them;
  - retention: the newest ``max_to_keep`` (3) plus, among older ones, one
    every ``TRAIN.CHECKPOINT_KEEP_N_HOUR`` hours (orbax's
    ``keep_time_interval``: the first, then each saved at least that long
    after the last one kept);
  - auto-resume from the newest complete checkpoint;
  - scalars to ``LOG_ROOT_DIR/fit/NAME/<time>/metrics.jsonl`` always, and
    to TensorBoard (scalars and similarity-matrix images) when
    ``TRAIN.TENSORBOARD`` is on and ``torch.utils.tensorboard`` imports.

In a run of several processes only the lead (rank 0, ``lead=True``)
writes: the other ranks' helpers restore checkpoints and write nothing.
"""
from __future__ import annotations

import datetime
import json
import os
import shutil
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from nafp_tpu_torch.models.convert import (flax_to_torch, load_params_npz,
                                           save_params_npz, torch_to_flax)


class ExperimentHelper:
    def __init__(self, checkpoint_name: str, cfg: Dict[str, Any],
                 max_to_keep: int = 3, lead: bool = True):
        self.checkpoint_name = checkpoint_name
        self.cfg = cfg
        self.max_to_keep = max_to_keep
        self.lead = lead
        log_root = cfg["DIR"]["LOG_ROOT_DIR"]
        self.ckpt_dir = os.path.abspath(
            os.path.join(log_root, "checkpoint", checkpoint_name))
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self.keep_sec = 3600.0 * float(
            cfg["TRAIN"].get("CHECKPOINT_KEEP_N_HOUR", 1) or 0)

        self.log_dir = os.path.join(
            log_root, "fit", checkpoint_name,
            datetime.datetime.now().strftime("%Y%m%d-%H%M%S-%f"))
        self._jsonl = self._tb = None
        self.epoch = 1  # 1-based like the reference (:58)
        if not lead:
            return
        os.makedirs(self.log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(self.log_dir, "metrics.jsonl"), "a")
        if cfg["TRAIN"].get("TENSORBOARD", True):
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                print("[experiment] torch.utils.tensorboard does not import; "
                      "metrics go to metrics.jsonl only")
            else:
                self._tb = SummaryWriter(self.log_dir)

    # ------------------------------------------------------------------
    def _meta(self, epoch: int) -> Optional[Dict[str, Any]]:
        path = os.path.join(self.ckpt_dir, str(epoch), "meta.json")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    def checkpoints(self) -> List[int]:
        """Epochs of the complete checkpoints, oldest first."""
        return sorted(int(d) for d in os.listdir(self.ckpt_dir)
                      if d.isdigit() and self._meta(int(d)) is not None)

    def latest_epoch(self) -> Optional[int]:
        ckpts = self.checkpoints()
        return ckpts[-1] if ckpts else None

    def restore_or_init(self, model: torch.nn.Module,
                        optimizer: torch.optim.Optimizer) -> int:
        """Load the newest checkpoint into ``model`` and ``optimizer`` when
        one exists (reference :125-137); returns the optimizer step."""
        latest = self.latest_epoch()
        if latest is None:
            print(f"[experiment] no checkpoint in {self.ckpt_dir}; "
                  "starting fresh")
            return 0
        d = os.path.join(self.ckpt_dir, str(latest))
        model.load_state_dict(flax_to_torch(load_params_npz(
            os.path.join(d, "params.npz"))), strict=True)
        # load_state_dict moves the moments to each parameter's device
        optimizer.load_state_dict(torch.load(
            os.path.join(d, "train_state.pt"), map_location="cpu",
            weights_only=True))
        self.epoch = latest + 1
        print(f"[experiment] restored epoch {latest} from {self.ckpt_dir}; "
              f"resuming at epoch {self.epoch}")
        return int(self._meta(latest)["step"])

    def save(self, epoch: int, model: torch.nn.Module,
             optimizer: torch.optim.Optimizer, step: int) -> None:
        """Write checkpoint ``epoch`` (replacing one of that index), then
        apply the retention policy. The lead only."""
        if not self.lead:
            return
        final = os.path.join(self.ckpt_dir, str(epoch))
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        save_params_npz(os.path.join(tmp, "params.npz"),
                        torch_to_flax(model.state_dict(), model.norm))
        torch.save(optimizer.state_dict(),
                   os.path.join(tmp, "train_state.pt"))
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"epoch": int(epoch), "step": int(step),
                       "time": time.time()}, f)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        self._apply_retention()

    def _apply_retention(self) -> None:
        ckpts = self.checkpoints()
        old = ckpts[:-self.max_to_keep] if self.max_to_keep else ckpts
        last_kept = None
        for ep in old:
            t = self._meta(ep)["time"]
            if self.keep_sec and (last_kept is None
                                  or t - last_kept >= self.keep_sec):
                last_kept = t
                continue
            shutil.rmtree(os.path.join(self.ckpt_dir, str(ep)))

    # ------------------------------------------------------------------
    @property
    def has_images(self) -> bool:
        """Whether image logging goes anywhere (TensorBoard only)."""
        return self._tb is not None

    def log_scalar(self, tag: str, value: float, step: int) -> None:
        if self._jsonl is None:
            return
        self._jsonl.write(json.dumps(
            {"tag": tag, "value": float(value), "step": int(step)}) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), step)

    def log_image(self, tag: str, matrix: np.ndarray, step: int) -> None:
        """Min-max-normalized matrix image."""
        if self._tb is None:
            return
        m = np.asarray(matrix, np.float32)
        lo, hi = m.min(), m.max()
        self._tb.add_image(tag, ((m - lo) / (hi - lo + 1e-12))[None], step)

    def log_sim_images(self, tag: str, logits: np.ndarray, step: int) -> None:
        """Pre/post-softmax similarity-matrix pair (reference
        write_image_tensorboard, experiment_helper.py:213-237)."""
        if self._tb is None:
            return
        m = np.asarray(logits, np.float32)
        self.log_image(f"{tag}/pre_softmax", m, step)
        e = np.exp(m - m.max(axis=1, keepdims=True))
        self.log_image(f"{tag}/post_softmax", e / e.sum(axis=1, keepdims=True),
                       step)

    def update_minitest_acc(self, accs_by_scope, scopes, key_str: str,
                            step: int) -> None:
        """Per-scope top-1 accuracy scalars (reference :190-209)."""
        for s, acc in zip(scopes, accs_by_scope[0]):
            self.log_scalar(f"mini_search/top1_{key_str}_scope{s}", acc, step)

    def close(self):
        if self._jsonl is not None:
            self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
