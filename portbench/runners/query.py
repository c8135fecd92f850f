"""ICASSP-protocol queries over an index of the port: one closed-loop
client, a request is one block of clips at one length.

Set-up makes, from the seed: the weights; ``db.n_songs`` songs and as many
noise tracks; the queries as the songs mixed with their noise at a drawn
SNR and amplitude; both fingerprinted by the port's encoder in batches of
``ts_batch_sz`` (the DB rows are the songs' segments at the model's hop,
query segment i is DB segment i degraded); ``db.n_dummy`` random unit rows
made on the card, put before the songs' rows; the index
(``nafp_tpu_torch.search.index.get_index``) over the host array, and the
re-rank copy on the card, as ``evaluate`` builds them. One pass of the
traffic then warms every shape up.

The window runs whole passes of the protocol: every length of
``seq_lens``, and for each the test ids in blocks of ``block``, each
through ``nafp_tpu_torch.search.evaluate._hits_for_block``. The pass
running when ``--seconds`` end runs to its end. A clip's latency is that
of its block.

Checked against the reference: ``enc_gap``, the widest distance of the
port's fingerprints of sampled batches from the reference's;
``answer_gap``, the widest score gap of the segment top-k and of the
ranked answers of sampled blocks (the search and re-rank followed from
the port's own fingerprints and hits: see ``reference/search.py``).
"""
from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from portbench import audio, weights
from portbench.runners import merged, port
from portbench.reference import encoder as ref_enc
from portbench.reference import search as ref_search
from portbench.registry import HERE
from portbench.run import Window


class Runner:
    def __init__(self, cell, seed: int, device, sizes=None, port_model=None):
        self.conf = merged(cell.config, sizes)
        self.traffic = merged(cell.traffic, sizes)
        self.seed, self.dev = int(seed), device
        self.port_model = port_model
        self.attempted = 0

    # -- set-up ----------------------------------------------------------
    def _audio(self):
        m, db, tr = self.conf["model"], self.conf["db"], self.traffic
        fs = int(m["FS"])
        gen = weights.generator(self.seed, 2, self.dev)
        song = audio.songs(gen, db["n_songs"], db["song_sec"], fs, self.dev)
        noise = audio.songs(gen, db["n_songs"], db["song_sec"], fs, self.dev)
        snr, amp = audio.draw_snr_amp(gen, db["n_songs"], tr["snr_db"],
                                      tr["amp"], self.dev)
        query = audio.bg_mix(song, noise, snr, amp)
        seg, hop = int(fs * float(m["DUR"])), int(fs * float(m["HOP"]))
        return audio.segments(song, seg, hop), audio.segments(query, seg, hop)

    def setup(self) -> None:
        from nafp_tpu_torch.device import chunked_device_put
        from nafp_tpu_torch.search.index import get_index

        conf, tr = self.conf, self.traffic
        m = conf["model"]
        self.w = weights.make(m, self.seed, self.dev)
        self.cfg = port.config(conf["preset"], m, self.port_model)
        model = port.fingerprinter(self.cfg, self.w, self.dev)
        self.db_segs, self.q_segs = self._audio()
        bsz = int(conf["ts_batch_sz"])
        db_emb = port.fingerprint(self.cfg, model, self.db_segs, bsz)
        q_emb = port.fingerprint(self.cfg, model, self.q_segs, bsz)
        del model
        d = db_emb.shape[1]
        dummy = torch.randn((conf["db"]["n_dummy"], d), device=self.dev,
                            generator=weights.generator(self.seed, 5,
                                                        self.dev))
        dummy /= torch.linalg.vector_norm(dummy, dim=1, keepdim=True)
        self.full_db = torch.cat([dummy, db_emb]).cpu().numpy()
        self.query = q_emb.cpu().numpy()
        del dummy, db_emb, q_emb
        ix = conf["index"]
        self.index = get_index(ix["type"], self.full_db,
                               nprobe=int(ix.get("nprobe", 40)),
                               device=self.dev)
        if hasattr(self.index, "add") and self.index.ntotal == 0:
            self.index.add(self.full_db)
        self.recon = chunked_device_put(self.full_db, self.dev)
        self.k = int(ix["k_probe"])
        ids = np.load(os.path.join(HERE, tr["test_ids"]))
        self.ids = ids[ids < len(self.query)]
        self._wrap_search()
        self._pass(None)                       # warm-up: every shape once
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def _wrap_search(self) -> None:
        """``index.search`` timed as its own span, its calls counted, its
        last answer kept for the check."""
        inner = self.index.search

        def search(q, k, *a, **kw):
            with self._win.span("search"):
                out = inner(q, k, *a, **kw)
            self._win.count("search_rows", len(q))
            rows = self._win.counts.setdefault("b1_rows", [])
            rows.extend(min(512, len(q) - s) for s in range(0, len(q), 512))
            self._last = (q, out[1])
            return out
        self._win = Window(False)             # the warm-up's, thrown away
        self.index.search = search

    # -- the window ------------------------------------------------------
    def _pass(self, lat: Optional[List]) -> None:
        from nafp_tpu_torch.search.evaluate import _hits_for_block
        blk = int(self.traffic["block"])
        for sl in self.traffic["seq_lens"]:
            for s in range(0, len(self.ids), blk):
                ids = self.ids[s:s + blk]
                t = time.perf_counter()
                with self._win.span("block"):
                    pred = _hits_for_block(self.index, self.recon,
                                           self.full_db, self.query, ids,
                                           int(sl), self.k)
                if lat is not None:
                    lat.append((time.perf_counter() - t, len(ids), int(sl)))
                    self._sample(ids, int(sl), pred)

    def _sample(self, ids, sl: int, pred) -> None:
        """Reservoir of ``check_blocks_per_len`` blocks per length, drawn
        from the seed (every array kept is one the block made afresh)."""
        res = self._res.setdefault(sl, [])
        self._seen[sl] = self._seen.get(sl, 0) + 1
        r = int(self.traffic["check_blocks_per_len"])
        j = len(res) if len(res) < r else int(
            self._rng.integers(self._seen[sl]))
        if j < r:
            keep = (ids, self._last[0], self._last[1], pred)
            if j == len(res):
                res.append(keep)
            else:
                res[j] = keep

    def window(self, seconds: float, win) -> None:
        self._win = win
        self._rng = np.random.default_rng(self.seed)
        self._res: Dict[int, list] = {}
        self._seen: Dict[int, int] = {}
        self.lat: List = []
        win.start()
        while True:
            self._pass(self.lat)
            win.count("passes")
            if time.perf_counter() - win.t0 >= seconds:
                break
        win.stop()
        self.attempted = sum(n for _, n, _ in self.lat)
        win.counts["blocks"] = [(sl, n) for _, n, sl in self.lat]

    def end_to_end(self, win) -> Dict[str, float]:
        lat = np.repeat([t for t, _, _ in self.lat],
                        [n for _, n, _ in self.lat])
        return {"query_clips_per_s": self.attempted / win.seconds,
                "query_p95_ms": float(np.percentile(lat, 95)) * 1e3}

    def work(self) -> Dict[str, Any]:
        n, d = self.full_db.shape
        return {"n_rows": int(n), "d": int(d), "k": self.k}

    def release(self) -> None:
        self.index = self.recon = None

    # -- the check -------------------------------------------------------
    def check(self) -> Dict[str, float]:
        ref_enc.no_tf32()
        m = self.conf["model"]
        w = {k: v.float() for k, v in self.w.items()}
        logmel = ref_enc.LogMel(m, self.dev)
        bsz = int(self.conf["ts_batch_sz"])
        n_batches = -(-len(self.db_segs) // bsz)
        rng = np.random.default_rng(self.seed + 1)
        picks = rng.choice(n_batches, min(n_batches,
                           int(self.traffic["check_batches"])), replace=False)
        enc_gap = 0.0
        for segs, emb in ((self.db_segs, self.full_db[-len(self.db_segs):]),
                          (self.q_segs, self.query)):
            for b in picks:
                s = int(b) * bsz
                x = segs[s:s + bsz]
                n = len(x)
                if n < bsz:
                    x = torch.cat([x, x.new_zeros((bsz - n, x.shape[1]))])
                with torch.no_grad():
                    ref = ref_enc.fingerprints(x, w, m, logmel)[:n]
                got = torch.as_tensor(emb[s:s + n], device=self.dev)
                enc_gap = max(enc_gap, float(torch.linalg.vector_norm(
                    got - ref, dim=1).max()))
        db = torch.as_tensor(self.full_db, device=self.dev)
        answer = 0.0
        for sl, blocks in sorted(self._res.items()):
            for ids, q_rows, hit_ids, pred in blocks:
                q = torch.as_tensor(q_rows, device=self.dev)
                b = len(ids)
                n_seg = np.minimum(len(self.query) - ids, sl)
                answer = max(answer, ref_search.topk_gap(q, db, hit_ids),
                             ref_search.rerank_gap(
                                 q.reshape(b, sl, -1),
                                 torch.as_tensor(n_seg, device=self.dev),
                                 hit_ids.reshape(b, sl, -1), db, pred))
        return {"enc_gap": enc_gap, "answer_gap": answer}
