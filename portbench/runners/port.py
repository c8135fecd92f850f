"""The calls into the port that every runner shares."""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch


def config(preset: str, model: Dict[str, Any],
           port_model: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The port's preset with the configuration's model keys over it."""
    from nafp_tpu_torch.configuration import load_config
    cfg = load_config(preset)
    cfg["MODEL"].update(model)
    cfg["MODEL"].update(port_model or {})
    return cfg


def fingerprinter(cfg: Dict[str, Any], weights: Dict[str, torch.Tensor],
                  device) -> torch.nn.Module:
    """The port's FingerPrinter holding ``weights``, in eval mode."""
    from nafp_tpu_torch.models.nnfp import get_fingerprinter
    model = get_fingerprinter(cfg)
    model.load_state_dict({k: v.cpu() for k, v in weights.items()},
                          strict=True)
    return model.to(device).eval()


def fingerprint(cfg: Dict[str, Any], model: torch.nn.Module,
                segs: torch.Tensor, bsz: int) -> torch.Tensor:
    """Fingerprints of (n, samples) segments through the port's log-mel
    and encoder, in the static batches ``generate`` feeds (the last one
    zero-padded), as float32 on the segments' device."""
    from nafp_tpu_torch.ops.melspec import get_melspec_fn
    melspec_fn, _ = get_melspec_fn(cfg)
    out = []
    with torch.inference_mode():
        for s in range(0, len(segs), bsz):
            x = segs[s:s + bsz]
            n = len(x)
            if n < bsz:
                x = torch.cat([x, x.new_zeros((bsz - n, x.shape[1]))])
            out.append(model(melspec_fn(x))[:n].float())
    return torch.cat(out)
