"""Published dense peaks of the cards the benchmark knows, keyed by
``torch.cuda.get_device_name``.

From NVIDIA's data sheets (SXM part, no sparsity), at the full power limit
of 700 W; the run records the card's own limit beside every number. A card
not listed here gets no share of a peak: its metrics are left out.
"""
from __future__ import annotations

from typing import Dict, Optional

PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops": 989.4e12,     # dense bf16 tensor cores
        "tf32_flops": 494.7e12,     # dense TF32 tensor cores
        "hbm_bytes": 3.35e12,       # HBM3 bandwidth
    },
}


def peak(kind: str, what: str) -> Optional[float]:
    return PEAKS.get(kind, {}).get(what)
