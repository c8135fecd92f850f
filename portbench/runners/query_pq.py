"""ICASSP-protocol queries over the port's IVF-PQ index, judged by the
plain IVF-PQ reference.

Set-up and window are the query runner's (``runners/query.py``); the
index is ``get_index("ivfpq", ...)`` as ``evaluate -i ivfpq`` builds it,
its k-means and codebooks trained on the DB rows themselves and seeded by
the run. The configuration's ``index`` states the values the build must
have (nlist, m, bits, ``LIST_TILE``); set-up fails where it has others.

Before ``release()`` drops the index, its trained state (centroids,
codebooks, the books the search decodes with) and its store (codes, ids,
list of each subtile) are kept on the host for the check, and the search
is run once more on each sampled block's query rows to keep the lists its
probe picked (``_pq_bias_list``, the port's probe, as the search calls
it; the search is deterministic, so these are the window's). Checked:

- ``enc_gap``: the query runner's;
- ``answer_gap``: the re-rank only (``reference/search.py::rerank_gap``
  on the port's own segment hits); the hits themselves are approximate;
- ``pq_gap``: the segment top-k of the sampled blocks against the plain
  IVF-PQ search (``reference/ivfpq.py::pq_gap``);
- ``probe_miss``: the probe of the sampled blocks' query rows
  (``reference/ivfpq.py::probe_miss``);
- ``code_gap``: the store, over ``CODE_ROWS`` rows drawn from the seed
  (all rows where there are fewer): ``reference/ivfpq.py::code_gap``;
- ``coarse_gap``, ``books_gap``: the build, over every DB row, the rows
  it was trained on (``reference/ivfpq.py::lloyd_gap``,
  ``books_lloyd_gap``).

``control`` (for ``control_pq.py``): ``pq_int8``, the index decodes from
its int8 codebooks instead (``IVFPQIndex(decode_int8=True)``); ``pq_fp8``,
each decoded chunk is rounded to float8 e4m3 before the scan, one
precision below the bf16 rows it scans.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from portbench.reference import ivfpq as ref_pq
from portbench.reference import search as ref_search
from portbench.runners import query

CONTROLS = (None, "pq_int8", "pq_fp8")
CODE_ROWS = 4096     # stored rows whose encoding is checked
CODE_BLOCK = 1024    # of them per float64 block


class Runner(query.Runner):
    def __init__(self, cell, seed: int, device, sizes=None, port_model=None,
                 control=None):
        if control not in CONTROLS:
            raise ValueError(control)
        super().__init__(cell, seed, device, sizes, port_model)
        self.control = control

    def setup(self) -> None:
        """The query runner's set-up, with the run's seed handed to the
        index's k-means and, for a control, its decode changed before the
        warm-up."""
        from nafp_tpu_torch.search import index as port_index
        plain = port_index.get_index

        def get_index(*a, **kw):
            idx = plain(*a, seed=self.seed % (1 << 31), **kw)
            idx.decode_int8 = self.control == "pq_int8"
            if self.control == "pq_fp8":
                decode = idx._decode_chunk
                idx._decode_chunk = lambda codes, sub: decode(codes, sub).to(
                    torch.float8_e4m3fn).to(torch.bfloat16)
            return idx
        port_index.get_index = get_index
        try:
            super().setup()
        finally:
            port_index.get_index = plain
        ix, idx = self.conf["index"], self.index
        built = {"nlist": idx.nlist, "m": idx.m, "nprobe": idx.nprobe,
                 "nbits": idx.ksub.bit_length() - 1,
                 "list_tile": idx.LIST_TILE}
        stated = {k: int(ix[k]) for k in built}
        if built != stated:
            raise ValueError(f"the index was built with {built}, the "
                             f"configuration states {stated}")

    def work(self) -> Dict[str, Any]:
        idx = self.index
        return {**super().work(), "nlist": idx.nlist, "nprobe": idx.nprobe,
                "m": idx.m, "ksub": idx.ksub, "n_pad": idx.n_pad,
                "list_tile": idx.LIST_TILE, "n_real": idx.ntotal}

    def release(self) -> None:
        idx = self.index
        books = idx.codebooks
        if idx.decode_int8:
            q8, scale = idx._quantized_books()
            books = q8.float() * scale[:, None, :]
        self.store = {k: getattr(idx, k).cpu().numpy() for k in (
            "centroids", "codebooks", "codes", "ids", "sub_list")}
        self.store.update(decode_books=books.cpu().numpy(),
                          nprobe=idx.nprobe, list_tile=idx.LIST_TILE)
        self.probed = self._probes(idx)
        super().release()

    def _probes(self, idx) -> Dict[int, list]:
        """The lists the port's search probes for each sampled block's
        query rows, (rows, nlist) bools on the host, per length."""
        from nafp_tpu_torch.search import index as port_index
        plain, got = port_index._pq_bias_list, []

        def bias(*a, **kw):
            out = plain(*a, **kw)
            got.append(out > port_index.NEG / 2)
            return out
        port_index._pq_bias_list = bias
        try:
            probed = {}
            for sl, blocks in self._res.items():
                probed[sl] = []
                for _, q_rows, _, _ in blocks:
                    got.clear()
                    type(idx).search(idx, q_rows, self.k)
                    probed[sl].append(torch.cat(got)[:len(q_rows)].cpu())
            return probed
        finally:
            port_index._pq_bias_list = plain

    # -- the check -------------------------------------------------------
    def check(self) -> Dict[str, float]:
        # the query runner's enc_gap alone (it switches TF32 off): its
        # answer_gap holds the search to the exact top-k, which IVF-PQ
        # is not
        sampled, self._res = self._res, {}
        try:
            enc_gap = super().check()["enc_gap"]
        finally:
            self._res = sampled
        dev = self.dev
        st = {k: torch.as_tensor(v, device=dev) if isinstance(v, np.ndarray)
              else v for k, v in self.store.items()}
        n = len(self.full_db)
        lists, codes = ref_pq.rows_of_store(st["codes"], st["ids"],
                                            st["sub_list"], st["list_tile"],
                                            n)
        recon = ref_pq.decode(st["centroids"], st["codebooks"], lists, codes)
        db = torch.as_tensor(self.full_db, device=dev)
        answer = pq = miss = 0.0
        for sl, blocks in sorted(self._res.items()):
            for (ids, q_rows, hit_ids, pred), probed in zip(
                    blocks, self.probed[sl]):
                q = torch.as_tensor(q_rows, device=dev)
                b = len(ids)
                n_seg = np.minimum(len(self.query) - ids, sl)
                miss = max(miss, ref_pq.probe_miss(
                    q, st["centroids"], st["nprobe"], probed))
                pq = max(pq, ref_pq.pq_gap(q, st["centroids"], recon, lists,
                                           st["nprobe"], hit_ids))
                answer = max(answer, ref_search.rerank_gap(
                    q.reshape(b, sl, -1),
                    torch.as_tensor(n_seg, device=dev),
                    hit_ids.reshape(b, sl, -1), db, pred))
        del recon
        rows = np.random.default_rng(self.seed + 2).permutation(n)[
            :CODE_ROWS]
        rows = torch.as_tensor(np.sort(rows), device=dev)
        code = 0.0
        for s in range(0, len(rows), CODE_BLOCK):
            r = rows[s:s + CODE_BLOCK]
            code = max(code, ref_pq.code_gap(
                db[r], st["centroids"], st["codebooks"], st["decode_books"],
                lists[r], codes[r]))
        return {"enc_gap": enc_gap, "answer_gap": answer, "pq_gap": pq,
                "probe_miss": miss, "code_gap": code,
                "coarse_gap": ref_pq.lloyd_gap(db, st["centroids"]),
                "books_gap": ref_pq.books_lloyd_gap(
                    db, st["centroids"], st["codebooks"], lists)}
