"""Spectral augmentation chain (SpecAugment + N-CutOut), vectorised.

Counterpart of ``nafp_tpu/ops/specaug.py`` (reference
``model/fp/specaug_chain/specaug_chain.py:43-192`` and
``layers/ncutout_tarray.py:38-301``) on a (B, F, T, 1) log-mel batch.
Masks are broadcast index comparisons, ``(b, n_holes, F, T)``.

Kept from the reference, as the JAX package keeps it:
  - 'cutout' rectangular holes, sizes in [dim//10, dim/2.5) per axis;
    'vertical' a full-height time stripe, width in [5, 16); 'horizontal'
    a full-width frequency stripe, height in [5, 20);
  - the centre/clip hole arithmetic (``ncutout_tarray.py:164-168``);
  - hole fillers 'min' / 'zeros' / 'random' / [lo, hi]; 'min' fills with
    the batch MEAN (the reference's quirk, reproduced);
  - ``uniform_mask`` (the default): one mask for the whole batch, all its
    holes active, and a per-sample Bernoulli gate with the layer's
    probability. Per-sample masks give an anchor and its replica
    different holes, which collapses NT-Xent training on the synthetic
    corpus (the loss pins at 2·ln(2n−1) after one optimizer step, as the
    JAX package measured).

Random draws come from a ``torch.Generator``; a layer's draws (hole
ranges, gates, filler) can be passed in instead through ``draws``.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch

LayerKind = str  # 'cutout' | 'vertical' | 'horizontal'
Ranges = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def hole_ranges(gen: torch.Generator, kind: LayerKind, b: int, n_holes: int,
                h: int, w: int, device=None) -> Ranges:
    """Random hole [start, end] (inclusive) ranges per (sample, hole):
    (y_start, y_end, x_start, x_end), each (b, n_holes) int64."""
    def randint(lo, hi):
        return torch.randint(lo, hi, (b, n_holes), generator=gen,
                             device=device)

    def full(v):
        return torch.full((b, n_holes), v, dtype=torch.int64, device=device)

    if kind == "cutout":
        ws = randint(w // 10, int(w / 2.5))
        hs = randint(h // 10, int(h / 2.5))
        xs = randint(0, w - 1)
        ys = randint(0, h - 1)
    elif kind == "vertical":    # full-height time stripe
        ws, hs = randint(5, 16), full(h)
        xs, ys = randint(0, w - 1), full(h // 2)
    elif kind == "horizontal":  # full-width frequency stripe
        ws, hs = full(w), randint(5, 20)
        xs, ys = full(w // 2), randint(0, h - 1)
    else:
        raise NotImplementedError(kind)
    x_start = torch.clamp(xs - ws // 2, 0, w - 2)
    x_end = torch.clamp(xs + ws // 2, 1, w - 1)
    y_start = torch.clamp(ys - hs // 2, 0, h - 2)
    y_end = torch.clamp(ys + hs // 2, 1, h - 1)
    return y_start, y_end, x_start, x_end


def _filler(x: torch.Tensor, hole_fill, gen: Optional[torch.Generator],
            fill: Optional[torch.Tensor]) -> torch.Tensor:
    """The hole filler, broadcastable to x."""
    if hole_fill == "zeros":
        return torch.zeros((), dtype=x.dtype, device=x.device)
    if hole_fill == "min":
        return x.mean()                              # the batch MEAN (quirk)
    if fill is None:
        fill = torch.rand(x.shape, generator=gen, device=x.device,
                          dtype=x.dtype)
    if hole_fill == "random":
        return fill * (x.max() - x.min()) + x.min()
    lo, hi = float(hole_fill[0]), float(hole_fill[1])
    return fill * (hi - lo) + lo


def _ncutout(x: torch.Tensor, kind: LayerKind, prob: float, n_holes: int,
             hole_fill, uniform_mask: bool, gen: Optional[torch.Generator],
             draws: Optional[Dict[str, Any]]) -> torch.Tensor:
    """One chain layer on (B, F, T, 1). ``draws`` may hold 'ranges'
    (hole_ranges' output), 'act' (uniform mask: (B, 1, 1, 1) bool gate;
    else (b, n_holes) bool hole activity) and 'fill' (a U[0, 1) tensor of
    x's shape for the random fillers)."""
    draws = draws or {}
    bsz, h, w, _ = x.shape
    b = 1 if uniform_mask else bsz
    ranges = draws.get("ranges")
    if ranges is None:
        ranges = hole_ranges(gen, kind, b, n_holes, h, w, x.device)
    ys, ye, xs, xe = ranges
    iy = torch.arange(h, device=x.device)[None, None, :]
    ix = torch.arange(w, device=x.device)[None, None, :]
    mask_h = (ys[..., None] <= iy) & (iy <= ye[..., None])    # (b, n, H)
    mask_w = (xs[..., None] <= ix) & (ix <= xe[..., None])    # (b, n, W)
    act = draws.get("act")
    if uniform_mask:
        hole_act = torch.ones((b, n_holes), dtype=torch.bool, device=x.device)
        if act is None:
            act = torch.rand((bsz, 1, 1, 1), generator=gen,
                             device=x.device) < prob
    else:
        hole_act = act if act is not None else torch.rand(
            (b, n_holes), generator=gen, device=x.device) < prob
    mask = torch.any(mask_h[:, :, :, None] & mask_w[:, :, None, :]
                     & hole_act[:, :, None, None], dim=1)[..., None]
    filler = _filler(x, hole_fill, gen, draws.get("fill"))
    if uniform_mask:
        mask = mask & act
    return torch.where(mask, filler, x)


def spec_augment(x: torch.Tensor,
                 gen: Optional[torch.Generator] = None,
                 chain: Tuple[LayerKind, ...] = ("cutout", "horizontal"),
                 probs: Union[float, Tuple[float, ...]] = 1.0,
                 n_holes: int = 1,
                 hole_fill="zeros",
                 uniform_mask: bool = True,
                 draws: Optional[Sequence[Dict[str, Any]]] = None
                 ) -> torch.Tensor:
    """Apply the ordered chain to a (B, F, T, 1) batch; ``draws`` holds one
    dict per layer (see ``_ncutout``) in place of the generator's draws."""
    if not isinstance(probs, tuple):
        probs = (float(probs),) * len(chain)
    if len(probs) < len(chain):
        probs = probs * len(chain)
    for i, kind in enumerate(chain):
        n = n_holes if kind == "cutout" else 1  # chain builder :114-143
        x = _ncutout(x, kind, probs[i], n, hole_fill, uniform_mask, gen,
                     draws[i] if draws else None)
    return x


def get_specaug_fn(cfg: Dict[str, Any]):
    """``(x, gen, draws=None) -> x`` from a config dict (counterpart of
    ``get_specaug_chain_layer``, specaug_chain.py:173-192)."""
    sa = cfg["SPEC_AUG"]
    hole_fill = sa["SPECAUG_HOLE_FILL"]
    if isinstance(hole_fill, list):
        hole_fill = tuple(hole_fill)
    probs = sa["SPECAUG_PROBS"]
    return functools.partial(
        spec_augment,
        chain=tuple(sa["SPECAUG_CHAIN"]),
        probs=tuple(probs) if isinstance(probs, list) else float(probs),
        n_holes=int(sa["SPECAUG_N_HOLES"]),
        hole_fill=hole_fill,
        uniform_mask=bool(sa.get("UNIFORM_MASK", True)))
