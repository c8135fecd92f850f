"""Training steps of the port's ``TrainStep``, back to back, each on a
fresh batch made on the card.

Set-up makes, from the seed: the weights; a corpus of ``corpus_songs``
songs, ``bg_clips`` background tracks and ``ir_clips`` impulse responses
held on the card (the ``DEVICE_CORPUS`` loader's situation). The train
step is built as ``extras/bench_train_step.measure`` builds it: the
preset's log-mel, SpecAugment and encoder, ``_make_loss_fn`` with its
bg/IR augmentation, the optimizer and schedule of ``build_optimizer``.

Step i's batch and random draws come from the seed and i: anchors cut at
random starts from random songs, each replica its anchor's song moved by
up to ``offset_margin`` seconds either way, a background cut from a random
track and a random impulse response; the SNR and amplitude of each mix
and the SpecAugment holes (one mask for the batch, as the preset's
``UNIFORM_MASK``) by the laws of ``ops/tdaug.draw_bg_mix`` and
``ops/specaug.hole_ranges``, handed to the step as its ``draws``.

Set-up drives the step through its first ``ref_steps`` steps by the
window's own call and feed, and reads there the losses, the first
gradient (from LAMB's first moment after step 1) and the change of every
parameter; the window goes on with the same object. The plain reference
then follows those steps from the same weights, batches and draws.
"""
from __future__ import annotations

import time
from typing import Any, Dict

import torch

from portbench import audio, weights
from portbench.runners import merged, port
from portbench.reference import arch
from portbench.reference import encoder as ref_enc
from portbench.reference import train as ref_train


def hole_ranges(gen: torch.Generator, kind: str, n: int, h: int, w: int,
                device):
    """(y0, y1, x0, x1), each (1, n): the port's SpecAugment hole law."""
    def randint(lo, hi):
        return torch.randint(lo, hi, (1, n), generator=gen, device=device)

    def full(v):
        return torch.full((1, n), v, dtype=torch.int64, device=device)

    if kind == "cutout":
        ws, hs = randint(w // 10, int(w / 2.5)), randint(h // 10, int(h / 2.5))
        xs, ys = randint(0, w - 1), randint(0, h - 1)
    elif kind == "vertical":
        ws, hs, xs, ys = randint(5, 16), full(h), randint(0, w - 1), full(h // 2)
    elif kind == "horizontal":
        ws, hs, xs, ys = full(w), randint(5, 20), full(w // 2), randint(0, h - 1)
    else:
        raise ValueError(kind)
    return (torch.clamp(ys - hs // 2, 0, h - 2), torch.clamp(ys + hs // 2, 1, h - 1),
            torch.clamp(xs - ws // 2, 0, w - 2), torch.clamp(xs + ws // 2, 1, w - 1))


class Runner:
    def __init__(self, cell, seed: int, device, sizes=None, port_model=None):
        self.conf = merged(cell.config, sizes)
        self.traffic = merged(cell.traffic, sizes)
        self.seed, self.dev = int(seed), device
        self.port_model = port_model
        self.attempted = 0

    # -- the feed --------------------------------------------------------
    def _corpus(self) -> None:
        tr, m = self.traffic, self.conf["model"]
        fs = int(m["FS"])
        gen = weights.generator(self.seed, 2, self.dev)
        self.songs = audio.songs(gen, tr["corpus_songs"], tr["song_sec"], fs,
                                 self.dev)
        self.bg = 0.5 * audio.songs(gen, tr["bg_clips"], tr["song_sec"], fs,
                                    self.dev)
        taps = torch.arange(tr["ir_len"], device=self.dev)
        self.ir = 0.3 * torch.exp(-taps / 100.0) * torch.randn(
            (tr["ir_clips"], tr["ir_len"]), generator=gen, device=self.dev)

    def feed(self, i: int):
        """Step i's batch and draws."""
        tr, conf, m = self.traffic, self.conf, self.conf["model"]
        fs = int(m["FS"])
        seg = arch.n_samples(m)
        n = int(conf["n_anchor"])
        gen = weights.generator(self.seed, 1000 + i, self.dev)
        dev = self.dev

        def ri(hi, size):
            return torch.randint(0, hi, size, generator=gen, device=dev)
        length = self.songs.shape[1]
        margin = int(tr["offset_margin"] * fs)
        song = ri(len(self.songs), (n,))
        a0 = margin + ri(length - seg - 2 * margin + 1, (n,))
        p0 = a0 + ri(2 * margin + 1, (n,)) - margin
        cols = torch.arange(seg, device=dev)
        bgi, bg0 = ri(len(self.bg), (n,)), ri(self.bg.shape[1] - seg + 1, (n,))
        batch = {"anchors": self.songs[song[:, None], a0[:, None] + cols],
                 "replicas": self.songs[song[:, None], p0[:, None] + cols],
                 "bg": self.bg[bgi[:, None], bg0[:, None] + cols],
                 "ir": self.ir[ri(len(self.ir), (n,))]}
        snr, amp = audio.draw_snr_amp(gen, n, conf["td_aug"]["snr_db"],
                                      conf["td_aug"]["amp"], dev)
        sa = conf["spec_aug"]
        h, w = int(m["N_MELS"]), arch.n_frames(m)
        spec = []
        for kind in sa["chain"]:
            holes = int(sa["n_holes"]) if kind == "cutout" else 1
            spec.append({"ranges": hole_ranges(gen, kind, holes, h, w, dev),
                         "act": torch.rand((2 * n, 1, 1, 1), generator=gen,
                                           device=dev) < float(sa["prob"])})
        return batch, {"td": {"snr": snr, "amp": amp}, "spec": spec}

    # -- set-up ----------------------------------------------------------
    def setup(self) -> None:
        from nafp_tpu_torch.optim.schedules import build_optimizer
        from nafp_tpu_torch.train import trainer as T

        conf = self.conf
        m, opt = conf["model"], conf["optimizer"]
        self.w0 = weights.make(m, self.seed, self.dev)
        cfg = port.config(conf["preset"], m, self.port_model)
        cfg["BSZ"]["TR_BATCH_SZ"] = 2 * int(conf["n_anchor"])
        cfg["BSZ"]["TR_N_ANCHOR"] = int(conf["n_anchor"])
        tr_cfg = cfg["TRAIN"]
        if (str(tr_cfg["OPTIMIZER"]).upper() != opt["name"].upper()
                or float(tr_cfg["LR"]) != float(opt["lr"])
                or str(tr_cfg["LR_SCHEDULE"]).upper()
                != opt["schedule"].upper()):
            raise ValueError(f"preset {conf['preset']!r} trains with "
                             f"{tr_cfg['OPTIMIZER']} at {tr_cfg['LR']} "
                             f"({tr_cfg['LR_SCHEDULE']}), not as the "
                             "configuration states")
        melspec_fn, specaug_fn, model, _ = T.build_fp(cfg)
        model.load_state_dict({k: v.cpu() for k, v in self.w0.items()},
                              strict=True)
        model.to(self.dev)
        optimizer, schedule = build_optimizer(cfg, model,
                                              int(opt["total_steps"]))
        loss_fn = T._make_loss_fn(cfg, melspec_fn, specaug_fn, model,
                                  train=True,
                                  aug_keys=frozenset(("bg", "ir")))
        self.model, self.opt = model, optimizer
        self.step_fn = T.TrainStep(cfg, model, optimizer, schedule, loss_fn,
                                   self.dev)
        self._corpus()
        b1 = opt["betas"][0]
        self.losses, self.grad = [], {}
        for i in range(int(self.traffic["ref_steps"])):
            loss, _ = self.step_fn(*self.feed(i))
            self.losses.append(loss)
            if i == 0:
                # a parameter the optimizer left without state has no
                # first moment: its gradient reads 0
                self.grad = {
                    k: torch.linalg.vector_norm(optimizer.state[p].get(
                        "exp_avg", torch.zeros(()))) / (1 - b1)
                    for k, p in model.named_parameters()}
        self.change = {k: torch.linalg.vector_norm(p.detach() - self.w0[k])
                       for k, p in model.named_parameters()}
        self.losses = [float(x) for x in self.losses]
        self.grad = {k: float(v) for k, v in self.grad.items()}
        self.change = {k: float(v) for k, v in self.change.items()}
        self.next = int(self.traffic["ref_steps"])

    # -- the window ------------------------------------------------------
    def window(self, seconds: float, win) -> None:
        steps = 0
        win.start()
        while time.perf_counter() - win.t0 < seconds:
            with win.span("step"):
                loss, _ = self.step_fn(*self.feed(self.next))
            self.next += 1
            steps += 1
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        win.stop()
        self.last_loss = float(loss)
        win.count("steps", steps)
        win.count("segments", steps * 2 * int(self.conf["n_anchor"]))
        self.attempted = steps

    def end_to_end(self, win) -> Dict[str, float]:
        return {"train_segments_per_s": win.counts["segments"] / win.seconds}

    def work(self) -> Dict[str, Any]:
        return {"model": self.conf["model"]}

    def release(self) -> None:
        self.step_fn = self.model = self.opt = None

    # -- the check -------------------------------------------------------
    def reference(self, **kw) -> Dict[str, Any]:
        ref_enc.no_tf32()
        n = int(self.traffic["ref_steps"])
        feeds = [self.feed(i) for i in range(n)]
        cfg = {"model": self.conf["model"], "optimizer": self.conf["optimizer"],
               "tau": float(self.conf["tau"]),
               "ir_taps": int(self.conf["ir_taps"])}
        return ref_train.steps(self.w0, [f[0] for f in feeds],
                               [f[1] for f in feeds], cfg, **kw)

    def check(self) -> Dict[str, float]:
        ref = self.reference()
        return compare(self.losses, self.grad, self.change, ref,
                       self.last_loss)


def compare(losses, grad, change, ref, last_loss=0.0) -> Dict[str, float]:
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"]))
    if last_loss != last_loss or abs(last_loss) == float("inf"):
        loss_gap = float("inf")          # the window's last loss not finite
    return {"loss_gap": loss_gap,
            "grad_gap": ref_train.worst_leaf_gap(grad, ref["grad_norms"],
                                                 ref["grad_norms"]),
            "change_gap": ref_train.worst_leaf_gap(change, ref["change"],
                                                   ref["grad_norms"])}
