"""Matplotlib image helpers for metric sinks.

Counterpart of ``nafp_tpu/utils/plotter.py`` (reference
``model/utils/plotter.py:44-108``: imshow -> PNG tensor for TensorBoard).
Matplotlib is optional and imported only when an image is drawn; the
trainer's ``ExperimentHelper.log_image`` writes the raw normalised matrix,
as the JAX package's does.
"""
from __future__ import annotations

import io
from typing import Optional

import numpy as np


def get_imshow_image(matrix: np.ndarray, title: Optional[str] = None,
                     cmap: str = "viridis") -> np.ndarray:
    """Render a matrix with imshow and return an (H, W, 4) RGBA uint8 array
    (reference get_imshow_image :76-108 + plot_to_image :44-73)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(6, 5))
    plt.imshow(np.asarray(matrix), origin="lower", cmap=cmap,
               aspect="auto")
    plt.colorbar()
    if title:
        plt.title(title)
    plt.tight_layout()
    buf = io.BytesIO()
    fig.savefig(buf, format="png")
    plt.close(fig)
    buf.seek(0)
    try:
        from PIL import Image
        img = np.asarray(Image.open(buf).convert("RGBA"))
    except ImportError:
        import matplotlib.image as mpimg
        img = (mpimg.imread(buf) * 255).astype(np.uint8)
    return img
