"""Work counts of the IVF-PQ re-rank (the refine of ``-i ivfpq-rr``) from
shapes: bytes of the function, not of one implementation of it.

Each counted row is one (query row, shortlist slot) pair: its raw f32 row
(4·d bytes), its int32 id and its f32 score read once; besides, each
query row's f32 query in (4·d) and its k f32 scores and k int32 ids out.
The function's products (2·d a counted row) are far below its bytes at
the card's peaks, so the bytes bound it.
"""
from __future__ import annotations


def refine_bytes(rows: float, nq: int, d: int, k: int) -> float:
    return rows * (4.0 * d + 8.0) + nq * (4.0 * d + 8.0 * k)


def refine_least_seconds(rows: float, nq: int, d: int, k: int,
                         bytes_peak: float) -> float:
    """Least time of the refine of ``rows`` counted rows of ``nq`` query
    rows: every byte once at ``bytes_peak``."""
    return refine_bytes(rows, nq, d, k) / bytes_peak
