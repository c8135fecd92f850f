"""Catalogue ingestion: ``nafp_tpu_torch.generate.generate_fingerprint``
over a folder of WAVs, back to back.

The catalogue (``n_songs`` synthetic songs of ``song_sec`` seconds,
16-bit WAVs) is made from the traffic's own ``catalogue_seed`` on a
checkout's first run and kept at a fixed path under the checkout's
``.portbench_work/``; the run's seed makes the weights, which go to the
port as the ``params.npz`` checkpoint ``generate`` reads. Set-up warms up
with one call over a folder of ``warm_songs`` songs (the same static batch
shape). The window then calls ``generate_fingerprint`` over the whole
catalogue again and again, each call into a folder of its own; the call
running when ``--seconds`` end runs to its end, and the window holds it.

Checked against the reference: ``row_gap``, the widest of the distance
of sampled (call, batch) pairs' rows from the reference's fingerprints of
the same WAVs, read and cut by the reference itself, and of |norm - 1|
over every row of every call (a row never written reads 1).
"""
from __future__ import annotations

import os
import shutil
import sys
import time
from typing import Any, Dict

import numpy as np
import torch

from portbench import audio, weights
from portbench.runners import merged, port
from portbench.reference import encoder as ref_enc
from portbench.registry import WORK

CKPT = "portbench"


class Runner:
    def __init__(self, cell, seed: int, device, sizes=None, port_model=None):
        self.conf = merged(cell.config, sizes)
        self.traffic = merged(cell.traffic, sizes)
        self.seed, self.dev = int(seed), device
        self.port_model = port_model
        self.attempted = 0
        self.base = os.path.join(WORK, "ingest")

    def _catalogue(self) -> str:
        tr, m = self.traffic, self.conf["model"]
        fs = int(m["FS"])
        name = (f"songs{tr['n_songs']}_sec{tr['song_sec']}_fs{fs}"
                f"_seed{tr['catalogue_seed']}")
        folder = os.path.join(WORK, "catalogue", name)
        done = os.path.join(folder, "done")
        if not os.path.exists(done):
            shutil.rmtree(folder, ignore_errors=True)
            gen = weights.generator(tr["catalogue_seed"], 2, self.dev)
            pcm = audio.pcm16(audio.songs(gen, tr["n_songs"], tr["song_sec"],
                                          fs, self.dev))
            audio.write_wavs(os.path.join(folder, "all"), pcm, fs)
            audio.write_wavs(os.path.join(folder, "warm"),
                             pcm[:tr["warm_songs"]], fs)
            open(done, "w").close()
        return folder

    def setup(self) -> None:
        from nafp_tpu_torch.models.convert import (save_params_npz,
                                                   torch_to_flax)
        m = self.conf["model"]
        self.folder = self._catalogue()
        self.w = weights.make(m, self.seed, self.dev)
        shutil.rmtree(self.base, ignore_errors=True)
        self.cfg = port.config(self.conf["preset"], m, self.port_model)
        self.cfg["DIR"]["LOG_ROOT_DIR"] = os.path.join(self.base, "logs")
        save_params_npz(os.path.join(self.base, "logs", "checkpoint", CKPT,
                                     "0", "params.npz"),
                        torch_to_flax(self.w, norm=m["BN"]))
        self._call("warm", os.path.join(self.folder, "warm"))
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def _call(self, tag: str, src: str) -> str:
        from nafp_tpu_torch.generate import generate_fingerprint
        return generate_fingerprint(
            self.cfg, CKPT, 0, source_root_dir=src,
            output_root_dir=os.path.join(self.base, "out", tag),
            assume_yes=True, device=self.dev)

    def window(self, seconds: float, win) -> None:
        src = os.path.join(self.folder, "all")
        self.outs = []
        win.start()
        self.call_s = []
        while True:
            t = time.perf_counter()
            with win.span("generate"):
                out = self._call(f"c{len(self.outs)}", src)
            self.call_s.append(time.perf_counter() - t)
            self.outs.append(out)
            n = int(np.load(os.path.join(out, "custom_source_shape.npy"))[0])
            win.count("segments", n)
            if time.perf_counter() - win.t0 >= seconds:
                break
        win.stop()
        win.count("calls", len(self.outs))
        print("generate calls (s): " + " ".join(f"{t:.3f}" for t in
                                                self.call_s), file=sys.stderr)
        self.attempted = win.counts["segments"]

    def end_to_end(self, win) -> Dict[str, float]:
        return {"fingerprint_segments_per_s": self.attempted / win.seconds}

    def work(self) -> Dict[str, Any]:
        return {"model": self.conf["model"]}

    def release(self) -> None:
        pass

    def check(self) -> Dict[str, float]:
        ref_enc.no_tf32()
        m = self.conf["model"]
        fs = int(m["FS"])
        seg, hop = int(fs * float(m["DUR"])), int(fs * float(m["HOP"]))
        n_seg = (int(fs * self.traffic["song_sec"]) - seg) // hop + 1
        bsz = int(self.conf["ts_batch_sz"])
        total = self.traffic["n_songs"] * n_seg
        rows = [np.memmap(os.path.join(o, "custom_source.mm"), np.float32,
                          "r", shape=(total, int(m["EMB_SZ"])))
                for o in self.outs]
        norm_err = max(float(np.abs(np.linalg.norm(r, axis=1) - 1).max())
                       for r in rows)
        rng = np.random.default_rng(self.seed + 1)
        n_batches = -(-total // bsz)
        picks = [(int(rng.integers(len(rows))), int(b)) for b in rng.choice(
            n_batches, min(n_batches, int(self.traffic["check_batches"])),
            replace=False)]
        logmel = ref_enc.LogMel(m, self.dev)
        files = sorted(os.listdir(os.path.join(self.folder, "all")))
        gap, songs = 0.0, {}
        for call, b in picks:
            g = np.arange(b * bsz, min(total, (b + 1) * bsz))
            x = torch.zeros((bsz, seg), device=self.dev)
            for j, gi in enumerate(g):
                f = files[gi // n_seg]
                if f not in songs:
                    songs[f] = audio.read_wav(os.path.join(self.folder,
                                                           "all", f))
                song = songs[f]
                s = (gi % n_seg) * hop
                piece = song[s:s + seg]
                x[j, :len(piece)] = torch.as_tensor(piece, device=self.dev)
            with torch.no_grad():
                ref = ref_enc.fingerprints(x, self.w, m, logmel)[:len(g)]
            got = torch.as_tensor(np.asarray(rows[call][g]), device=self.dev)
            gap = max(gap, float(torch.linalg.vector_norm(got - ref,
                                                          dim=1).max()))
        shutil.rmtree(os.path.join(self.base, "out"), ignore_errors=True)
        return {"row_gap": max(gap, norm_err)}
