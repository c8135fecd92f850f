"""ICASSP-protocol queries over the port's IVF-PQ index with an exact
re-rank (``-i ivfpq-rr``), judged by the plain IVF-PQ and re-rank
references.

Set-up and window are the IVF-PQ runner's (``runners/query_pq.py``): the
index is ``get_index("ivfpq-rr", ...)``, which keeps the raw f32 rows on
the card beside the codes and re-scores a shortlist of ``shortlist_factor
· k`` PQ candidates of each query row on them (``_pq_refine``). Set-up
fails unless the index was built with ``refine`` and every refine of the
warm-up saw shortlists of the configuration's width.

After the window, each sampled block's query rows are searched once more
(the search is deterministic, so these are the window's): with the
refine, for the scores the answer reported, whose ids must be the
window's; and with the refine off at the shortlist's width, for the
shortlist the refine saw. Checked:

- ``enc_gap``, ``answer_gap``, ``probe_miss``, ``code_gap``,
  ``coarse_gap``, ``books_gap``: as the IVF-PQ runner computes them;
- ``pq_gap``: the shortlist, against the plain IVF-PQ search at its
  width (``reference/ivfpq.py::pq_gap``); the IVF-PQ runner's reading of
  the final answers is replaced, since the re-rank breaks their PQ order
  by design;
- ``refine_gap``: the final top k against the float64 re-rank of that
  shortlist (``reference/ivfpq_rr.py::refine_gap``).

``control`` (for ``control_rr.py``), besides the IVF-PQ runner's:
``rr_tf32``, the refine's product in TF32 (both operands rounded to TF32,
10 bits of mantissa to the nearest even, the products summed in f32, as a
TF32 tensor-core product computes); ``rr_none``, the shortlist's first k
in PQ order with their PQ scores, no re-score.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from portbench.reference import ivfpq as ref_pq
from portbench.reference import ivfpq_rr as ref_rr
from portbench.runners import query_pq

RR_CONTROLS = ("rr_tf32", "rr_none")
CONTROLS = query_pq.CONTROLS + RR_CONTROLS


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (f32) rounded to TF32's 10 bits of mantissa, to the nearest
    even."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


class Runner(query_pq.Runner):
    def __init__(self, cell, seed: int, device, sizes=None, port_model=None,
                 control=None):
        if control not in CONTROLS:
            raise ValueError(control)
        super().__init__(cell, seed, device, sizes, port_model,
                         None if control in RR_CONTROLS else control)
        self.control = control
        self._patched = {}

    # -- the port's refine, seen (and, for a control, replaced) ----------
    def _patch(self, name, fn) -> None:
        from nafp_tpu_torch.search import index as port_index
        self._patched.setdefault(name, getattr(port_index, name))
        setattr(port_index, name, fn)

    def _unpatch(self) -> None:
        from nafp_tpu_torch.search import index as port_index
        for name, fn in self._patched.items():
            setattr(port_index, name, fn)
        self._patched = {}

    def _refine_of(self, plain):
        """The refine the window runs: the port's, or the control's."""
        if self.control == "rr_tf32":
            rounded = {}                # the raw rows, rounded once

            def refine(q, raw, best_i, *, k):
                if not rounded:
                    rounded["rows"] = tf32(raw)
                return plain(tf32(q), rounded["rows"], best_i, k=k)
            return refine
        if self.control == "rr_none":
            return lambda q, raw, best_i, *, k: (best_i.pq_v[:, :k],
                                                 best_i[:, :k])
        return plain

    def setup(self) -> None:
        from nafp_tpu_torch.search import index as port_index
        refine = self._refine_of(port_index._pq_refine)
        seen = set()

        def watched(q, raw, best_i, *, k):
            seen.add((best_i.shape[1], k))
            return refine(q, raw, best_i, k=k)
        self._patch("_pq_refine", watched)
        if self.control == "rr_none":
            merge = port_index._merge_topk

            def merge_keeping_scores(*a):
                v, i = merge(*a)
                i.pq_v = v
                return v, i
            self._patch("_merge_topk", merge_keeping_scores)
        try:
            super().setup()
            ix = self.conf["index"]
            width = int(ix["shortlist_factor"]) * self.k
            if not self.index.refine:
                raise ValueError("the index was built without its refine; "
                                 f"the configuration states {ix['type']}")
            if seen != {(width, self.k)}:
                raise ValueError(
                    f"the refine saw (shortlist, k) {sorted(seen)}, the "
                    f"configuration states {(width, self.k)}")
        except BaseException:
            self._unpatch()
            raise
        self.width = width
        if self.control in RR_CONTROLS:
            self._patch("_pq_refine", refine)
        else:
            self._unpatch()             # the window runs the port's path

    def release(self) -> None:
        """The IVF-PQ runner's, after the sampled blocks' second searches
        (the control, if any, still in place)."""
        idx = self.index
        self.answers: Dict[int, list] = {}
        try:
            for sl, blocks in self._res.items():
                self.answers[sl] = []
                for _, q_rows, hit_ids, _ in blocks:
                    scores, ids = type(idx).search(idx, q_rows, self.k)
                    idx.refine = False
                    try:
                        short = type(idx).search(idx, q_rows, self.width)[1]
                    finally:
                        idx.refine = True
                    same = np.array_equal(ids, hit_ids)
                    self.answers[sl].append((short, scores, ids, same))
        finally:
            self._unpatch()
        super().release()

    # -- the check -------------------------------------------------------
    def check(self) -> Dict[str, float]:
        # the IVF-PQ runner's checks; its pq_gap (of the final answers) is
        # replaced below
        out = super().check()
        dev = self.dev
        st = {k: torch.as_tensor(self.store[k], device=dev)
              for k in ("centroids", "codebooks", "codes", "ids",
                        "sub_list")}
        db = torch.as_tensor(self.full_db, device=dev)
        lists, codes = ref_pq.rows_of_store(
            st["codes"], st["ids"], st["sub_list"], self.store["list_tile"],
            len(db))
        recon = ref_pq.decode(st["centroids"], st["codebooks"], lists, codes)
        pq = rr = 0.0
        for sl, blocks in sorted(self._res.items()):
            for (_, q_rows, _, _), (short, scores, ids, same) in zip(
                    blocks, self.answers[sl]):
                q = torch.as_tensor(q_rows, device=dev)
                pq = max(pq, ref_pq.pq_gap(q, st["centroids"], recon, lists,
                                           self.store["nprobe"], short))
                rr = max(rr, ref_rr.refine_gap(q, db, short, scores, ids)
                         if same else float("inf"))
        out.update(pq_gap=pq, refine_gap=rr)
        return out
