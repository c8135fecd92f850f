"""nafp_tpu_torch — neural audio fingerprinting in PyTorch on an NVIDIA GPU.

The PyTorch + CUDA port of ``nafp_tpu`` (the JAX package stays in this
repository as the reference). Module names mirror the JAX package's so
each counterpart is easy to find. This package imports ``torch`` and never
``jax`` or ``nafp_tpu``.

Ported so far (the serving path): log-mel frontend, FingerPrinter encoder,
fingerprint generation to memmaps, exact search (``l2``/``ip``/``ivf`` over
f32, ``sq8``/``sq8-flat`` over int8) with hand-written CUDA top-k kernels,
and the ICASSP sequence-search protocol.

Package layout
--------------
- ``device``   — explicit device resolution (CUDA unless the CPU is asked for)
- ``ops``      — DSP frontend (log-mel)
- ``models``   — the FingerPrinter encoder and the Flax -> torch converter
- ``data``     — audio IO, segment catalogs, host batch loader
- ``search``   — top-k kernels, exact indexes, sequence re-ranking, evaluation
- ``csrc``     — CUDA C++ sources of the kernels (built with nvcc at first use)
"""

__version__ = "0.1.0"
