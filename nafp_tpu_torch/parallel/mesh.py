"""Process-level data sharding.

Counterpart of ``process_shard`` in ``nafp_tpu/parallel/mesh.py``; the
rest of that module (distributed init, device meshes) belongs to the
multi-process slice (ROADMAP.md Queue 1 item 11).
"""
from __future__ import annotations

from typing import Iterable, List

import torch.distributed as dist


def process_shard(items: Iterable) -> List:
    """This process's round-robin share of a host-side work list (song
    files): by rank over the world size when a ``torch.distributed``
    process group is up, the whole list otherwise."""
    items = list(items)
    if not (dist.is_available() and dist.is_initialized()):
        return items
    return items[dist.get_rank()::dist.get_world_size()]
