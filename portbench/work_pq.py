"""Work counts of an IVF-PQ search call from shapes: operations and bytes
of the function, not of one implementation of it (a fused decode-and-scan
is read against the same yardstick as decode, then scan).

The useful products are 2·d for each (query row, real row of a list it
probes) pair; the bytes are every input and output once: the codes
(``n_pad`` x m bytes), the ids (int32 a slot), the list of each
``list_tile``-row subtile (int32), the centroids and codebooks (f32), the
f32 queries, and k f32 scores and k int32 ids a query row.
"""
from __future__ import annotations


def search_flops(probed_rows: float, d: int) -> float:
    return 2.0 * d * probed_rows


def search_bytes(nq: int, n_pad: int, m: int, list_tile: int, nlist: int,
                 ksub: int, d: int, k: int) -> float:
    store = n_pad * m + 4.0 * n_pad + 4.0 * n_pad / list_tile
    state = 4.0 * (nlist * d + ksub * d)        # centroids, m·ksub·dsub
    return store + state + 4.0 * nq * d + 8.0 * nq * k


def search_least_seconds(nq: int, probed_rows: float, w, flops_peak: float,
                         bytes_peak: float) -> float:
    """Least time of one call of ``nq`` query rows probing
    ``probed_rows`` rows in all, over the store ``w`` (a runner's
    ``work()``): the larger of the products at ``flops_peak`` and the
    bytes at ``bytes_peak``."""
    nbytes = search_bytes(nq, w["n_pad"], w["m"], w["list_tile"], w["nlist"],
                          w["ksub"], w["d"], w["k"])
    return max(search_flops(probed_rows, w["d"]) / flops_peak,
               nbytes / bytes_peak)
