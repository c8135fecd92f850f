"""One runner per kind of traffic, named by a traffic file's ``runner``.

A runner's ``Runner(cell, seed, device, sizes=None, port_model=None)``
builds the cell in ``setup()``, drives the port through ``window(seconds,
win)``, reports ``end_to_end(win)``, ``attempted`` and ``work()``, frees
the port's state in ``release()`` and compares what the window produced
with the plain reference in ``check()``. ``sizes`` shrinks a cell for the
CPU tests (it merges into the configuration and the traffic);
``port_model`` merges into the port's ``MODEL`` section only (a control
run's lower-precision path).
"""
from __future__ import annotations

import copy
from typing import Any, Dict, Optional


def merged(base: Dict[str, Any], extra: Optional[Dict[str, Any]]
           ) -> Dict[str, Any]:
    """``base`` with ``extra``'s keys merged in, nested dicts key by key."""
    out = copy.deepcopy(base)
    for k, v in (extra or {}).items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merged(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out
